"""Tensor-parallel sharding rules for the ViT encoder.

Port of ``cbas_tpu/parallel/tp.py``. Head and intermediate dims are split
over a "model" mesh axis, composed with batch data parallelism over "data"
(a 2-D mesh): attention q/k/v and MLP up-projections split their output dim,
out-projections split their input dim, so each block needs exactly one sum
of partials per out-projection (``models/vit.py::_maybe_psum``).

A spec is the JAX package's ``PartitionSpec`` as a plain tuple, one entry a
dim: ``("model", None)`` splits dim 0, ``(None, "model")`` dim 1,
``("model",)`` a bias, ``()`` replicates. :func:`shard_vit_params` cuts a
param dict by them into one dict per model shard.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from cbas_tpu_torch.parallel.mesh import Mesh

Spec = Tuple

# Key suffixes whose *output* dim (dim 0 of the torch-layout (out, in) weight)
# is split across the model axis.
_SPLIT_OUT = (
    "attention.attention.query.weight",
    "attention.attention.key.weight",
    "attention.attention.value.weight",
    "attention.q_proj.weight",
    "attention.k_proj.weight",
    "attention.v_proj.weight",
    "mlp.fc1.weight",
    "mlp.up_proj.weight",
    "mlp.gate_proj.weight",
    # NOT mlp.weights_in: SwiGLU packs [x1; x2] along its out dim, which an
    # out-dim shard would split across devices incorrectly (models/vit.py
    # _mlp keeps SwiGLU replicated).
)
_SPLIT_OUT_BIAS = tuple(k.replace(".weight", ".bias") for k in _SPLIT_OUT)

# Keys whose *input* dim (dim 1) is split (the contraction that needs a psum).
_SPLIT_IN = (
    "attention.output.dense.weight",
    "attention.o_proj.weight",
    "mlp.fc2.weight",
    "mlp.down_proj.weight",
)


def vit_param_spec(key: str) -> Spec:
    if key.endswith(_SPLIT_OUT):
        return ("model", None)
    if key.endswith(_SPLIT_OUT_BIAS):
        return ("model",)
    if key.endswith(_SPLIT_IN):
        return (None, "model")
    return ()  # embeddings, norms, layerscales, biases of out-projections


_ATTN_KEYS = (
    "attention.attention.query", "attention.attention.key",
    "attention.attention.value", "attention.output.dense",
    "attention.q_proj", "attention.k_proj", "attention.v_proj",
    "attention.o_proj",
)


def vit_param_pspecs(params: Dict, mesh: Mesh, head_dim: int) -> Dict[str, Spec]:
    """Per-parameter spec, with a replicate fallback for dims the mesh
    doesn't divide (e.g. tiny test models).

    ``head_dim`` is required (cfg.head_dim): attention projections only split
    if every shard gets a whole number of heads — a defaulted/zero value would
    silently accept mid-head shards, which scramble the per-head attention
    math (the reshape inside _attention fails at trace time at best)."""
    if head_dim <= 0:
        raise ValueError("head_dim must be the model's positive head size")
    out = {}
    model_size = mesh.shape.get("model", 1)
    for k, v in params.items():
        spec = vit_param_spec(k) if "model" in mesh.axis_names else ()
        dims = v.shape  # numpy arrays and tensors both carry .shape
        ok = True
        for axis_idx, axis_name in enumerate(spec):
            if axis_name != "model":
                continue
            unit = model_size
            if any(a in k for a in _ATTN_KEYS):
                unit = model_size * head_dim
            if dims[axis_idx] % unit != 0:
                ok = False
        out[k] = spec if ok else ()
    return out


def shard_vit_params(params: Dict, specs: Dict[str, Spec], model_size: int) -> List[Dict]:
    """``params`` cut by ``specs`` into one dict per model shard: shard j
    holds the j-th of ``model_size`` equal parts of each split dim, as a
    contiguous copy (so a device that receives it holds only its part), and
    the same object for every replicated entry. Works on numpy arrays and
    tensors alike."""
    shards: List[Dict] = [{} for _ in range(model_size)]
    for k, v in params.items():
        spec = specs.get(k, ())
        if "model" not in spec:
            for shard in shards:
                shard[k] = v
            continue
        axis = spec.index("model")
        part = v.shape[axis] // model_size
        for j, shard in enumerate(shards):
            index = (slice(None),) * axis + (slice(j * part, (j + 1) * part),)
            piece = v[index]
            shard[k] = piece.contiguous() if hasattr(piece, "contiguous") else piece.copy()
    return shards
