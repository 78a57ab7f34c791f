"""Carry the JAX package's parameters across to the port.

Both packages keep parameters as flat dicts under HF/torch ``state_dict``
names, and ``jax.device_get`` turns a JAX param dict into numpy arrays. These
functions turn such a numpy dict into the port's: tensors on a device, float
arrays in the compute dtype. Given the same numpy dict, both packages compute
the same function.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cbas_tpu_torch.models.heads import (
    DeltasHead,
    DeltasHeadConfig,
    LegacyHead,
    LegacyHeadConfig,
)
from cbas_tpu_torch.models.vit import ViTConfig, vit_param_shapes


def vit_params_from_numpy(
    params_np: Mapping[str, np.ndarray],
    cfg: ViTConfig,
    device="cpu",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Numpy ViT params -> tensors on ``device``; float arrays cast to ``dtype``.

    Every key must be a parameter of ``cfg`` with the shape ``cfg`` gives it
    (a checkpoint of another architecture raises here, not deep in the
    forward). Keys may be missing: callers drop the ones their forward never
    reads.
    """
    spec = vit_param_shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, arr in params_np.items():
        arr = np.asarray(arr)
        if name not in spec:
            raise ValueError(f"'{name}' is not a parameter of {cfg}")
        if tuple(arr.shape) != spec[name][0]:
            raise ValueError(f"'{name}' has shape {arr.shape}, config says {spec[name][0]}")
        t = torch.from_numpy(np.array(arr))  # a private, writable copy
        out[name] = t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
    return out


def deltas_params_from_numpy(
    params_np: Mapping[str, np.ndarray],
    cfg: DeltasHeadConfig,
    device="cpu",
) -> DeltasHead:
    """Numpy deltas-head params -> a float32 :class:`DeltasHead` in eval mode
    on ``device``. The names are the module's own ``state_dict`` names, so the
    load is strict: a missing or unexpected key raises."""
    head = DeltasHead(cfg)
    head.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params_np.items()}
    )
    return head.to(device).eval()


def legacy_params_from_numpy(
    params_np: Mapping[str, np.ndarray],
    cfg: LegacyHeadConfig,
    device="cpu",
) -> LegacyHead:
    """Numpy v2-head params -> a float32 :class:`LegacyHead` in eval mode on
    ``device``. Strict like the deltas load, except BatchNorm's
    ``num_batches_tracked``, which bundles do not store (eval never reads it)."""
    head = LegacyHead(cfg)
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params_np.items()}
    state.setdefault("batch_norm.num_batches_tracked", torch.tensor(0))
    head.load_state_dict(state)
    return head.to(device).eval()
