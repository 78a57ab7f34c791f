"""DINOv2 (with registers) and DINOv3 vision transformers in PyTorch.

Port of ``cbas_tpu/models/vit.py``. Parameters are flat dicts of tensors keyed
by the HF ``state_dict`` names, as in the JAX package, and the forward is a set
of plain tensor functions over that dict, so both packages compute the same
thing from the same numbers.

The configuration code (``ViTConfig``, ``PRESETS``, ``config_for_identifier``)
is a copy: the JAX module imports jax at the top.

What differs from the JAX forward:

- Every full block's attention runs through one of the fused kernels of
  :mod:`cbas_tpu_torch.ops.flash_attention`, routed by the JAX package's
  rule (see :func:`_attention`): the hand-written kernel on a CUDA tensor,
  its plain version on a CPU tensor. There is no unfused path to switch to:
  the JAX package's ``set_fused_attention`` has no counterpart.
- The head-pair packed layout is a strided view of the flat projections:
  K2 reads and writes through their strides, so no copy is made of q, k, v
  or the context. The head-major layout (K3) comes from them by a
  transpose: one copy each of q, k, v and the context, as XLA makes for the
  JAX package's projection einsums into that layout.
- No token padding (the TPU's sublane granule), so no key masking inside the
  model.

Tensor parallelism, as in the JAX package: the attention and MLP code reads
the local head count and intermediate width off the weights, so the same
forward serves one device and a model shard (``parallel/tp.py`` cuts the
weights); under :class:`tp_psum_axis` each out-projection's partial is summed
over the shards (``parallel/mesh.py::AllReduce``) before its replicated bias
is added, once.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cbas_tpu_torch.ops import flash_attention as fa

Params = Dict[str, torch.Tensor]
Rope = Tuple[torch.Tensor, torch.Tensor]

# Tensor-parallel reduction (set by parallel/mesh.py's 2-D shard runner in
# each shard's thread). When set, _attention/_attention_cls/_mlp sum their
# out-projection partials through it iff their weights arrived sharded
# (detected from the weight shapes vs the config's full dims). Thread-local:
# each shard's thread runs its own forward, and a plain encoder on another
# thread must not see a shard's reduction.
_TP_STATE = threading.local()


class tp_psum_axis:
    """Context manager enabling TP partial sums through ``psum``, a function
    that returns the sum of one tensor over this shard's model-axis group
    (None disables)."""

    def __init__(self, psum: Optional[Callable[[torch.Tensor], torch.Tensor]]):
        self.psum = psum
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TP_STATE, "psum", None)
        _TP_STATE.psum = self.psum
        return self

    def __exit__(self, *exc):
        _TP_STATE.psum = self._prev


def _maybe_psum(y: torch.Tensor) -> torch.Tensor:
    """``y`` summed over this thread's model-axis group, if it has one."""
    psum = getattr(_TP_STATE, "psum", None)
    return psum(y) if psum is not None else y


@dataclass(frozen=True)
class ViTConfig:
    variant: str = "dinov2"  # "dinov2" (with registers) | "dinov3"
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    patch_size: int = 16
    num_register_tokens: int = 4
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-6
    image_size: int = 224          # pretraining geometry (pos-embed grid for dinov2)
    use_swiglu_ffn: bool = False   # dinov2 giant
    use_gated_mlp: bool = False    # dinov3 large+
    rope_theta: float = 100.0      # dinov3
    # dinov3 per-projection bias flags (dinov2 uses qkv_bias for all three)
    query_bias: bool = True
    key_bias: bool = False
    value_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    # tanh-approximated GELU; off by default (HF parity), on for the bf16
    # encode path, where the deviation sits below the fp16 store's rounding.
    gelu_approximate: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_prefix_tokens(self) -> int:
        return 1 + self.num_register_tokens

    @classmethod
    def from_hf(cls, hf_config) -> "ViTConfig":
        """Build from a transformers Dinov2[WithRegisters]Config or DINOv3ViTConfig."""
        t = type(hf_config).__name__
        if "DINOv3" in t:
            return cls(
                variant="dinov3",
                hidden_size=hf_config.hidden_size,
                num_layers=hf_config.num_hidden_layers,
                num_heads=hf_config.num_attention_heads,
                patch_size=hf_config.patch_size,
                num_register_tokens=hf_config.num_register_tokens,
                intermediate_size=hf_config.intermediate_size,
                layer_norm_eps=hf_config.layer_norm_eps,
                image_size=hf_config.image_size,
                use_gated_mlp=hf_config.use_gated_mlp,
                rope_theta=hf_config.rope_theta,
                query_bias=hf_config.query_bias,
                key_bias=hf_config.key_bias,
                value_bias=hf_config.value_bias,
                proj_bias=hf_config.proj_bias,
                mlp_bias=hf_config.mlp_bias,
            )
        inter = int(hf_config.hidden_size * hf_config.mlp_ratio)
        if hf_config.use_swiglu_ffn:
            # HF Dinov2SwiGLUFFN: hidden width is 2/3 of hidden*mlp_ratio,
            # rounded up to a multiple of 8.
            inter = (int(inter * 2 / 3) + 7) // 8 * 8
        return cls(
            variant="dinov2",
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            patch_size=hf_config.patch_size,
            num_register_tokens=getattr(hf_config, "num_register_tokens", 0),
            intermediate_size=inter,
            layer_norm_eps=hf_config.layer_norm_eps,
            image_size=hf_config.image_size,
            use_swiglu_ffn=hf_config.use_swiglu_ffn,
        )


PRESETS: Dict[str, ViTConfig] = {
    "dinov2-with-registers-base": ViTConfig(
        variant="dinov2", hidden_size=768, num_layers=12, num_heads=12,
        patch_size=14, num_register_tokens=4, intermediate_size=3072,
        image_size=518,
    ),
    "dinov2-with-registers-small": ViTConfig(
        variant="dinov2", hidden_size=384, num_layers=12, num_heads=6,
        patch_size=14, num_register_tokens=4, intermediate_size=1536,
        image_size=518,
    ),
    "dinov3-vits16": ViTConfig(
        variant="dinov3", hidden_size=384, num_layers=12, num_heads=6,
        patch_size=16, num_register_tokens=4, intermediate_size=1536,
        layer_norm_eps=1e-5, rope_theta=100.0,
    ),
    "dinov3-vitb16": ViTConfig(
        variant="dinov3", hidden_size=768, num_layers=12, num_heads=12,
        patch_size=16, num_register_tokens=4, intermediate_size=3072,
        layer_norm_eps=1e-5, rope_theta=100.0,
    ),
    "dinov3-vitl16": ViTConfig(
        variant="dinov3", hidden_size=1024, num_layers=24, num_heads=16,
        patch_size=16, num_register_tokens=4, intermediate_size=4096,
        layer_norm_eps=1e-5, rope_theta=100.0,
    ),
}


def _config_from_local_json(identifier: str) -> Optional[ViTConfig]:
    """A local checkpoint directory with an HF-style ``config.json`` describes
    its own architecture. Absent keys resolve to each family's class default
    (HF writes config.json with use_diff=True)."""
    import json
    import os

    path = os.path.join(identifier, "config.json")
    if not os.path.isdir(identifier) or not os.path.exists(path):
        return None
    with open(path) as f:
        c = json.load(f)
    model_type = c.get("model_type", "")
    is_v3 = "dinov3" in model_type
    common = dict(
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        patch_size=c["patch_size"],
        num_register_tokens=c.get(
            "num_register_tokens", 4 if "register" in model_type else 0
        ),
        layer_norm_eps=c.get("layer_norm_eps", 1e-5 if is_v3 else 1e-6),
    )
    if is_v3:
        return ViTConfig(
            variant="dinov3",
            intermediate_size=c["intermediate_size"],
            rope_theta=c.get("rope_theta", 100.0),
            use_gated_mlp=c.get("use_gated_mlp", False),
            query_bias=c.get("query_bias", True),
            key_bias=c.get("key_bias", False),
            value_bias=c.get("value_bias", True),
            proj_bias=c.get("proj_bias", True),
            mlp_bias=c.get("mlp_bias", True),
            **common,
        )
    use_swiglu = c.get("use_swiglu_ffn", False)
    inter = c.get("intermediate_size")
    if inter is None:
        inter = int(c["hidden_size"] * c.get("mlp_ratio", 4))
        if use_swiglu:
            inter = (int(inter * 2 / 3) + 7) // 8 * 8
    return ViTConfig(
        variant="dinov2",
        intermediate_size=int(inter),
        image_size=c.get("image_size", 518),
        use_swiglu_ffn=use_swiglu,
        **common,
    )


def config_for_identifier(identifier: str) -> ViTConfig:
    """Resolve a model identifier to a ViTConfig: a local directory's
    config.json, then the HF cache (local files only), then the longest
    preset name the identifier contains."""
    local = _config_from_local_json(identifier)
    if local is not None:
        return local
    try:
        import transformers

        hf = transformers.AutoConfig.from_pretrained(identifier, local_files_only=True)
        return ViTConfig.from_hf(hf)
    except Exception:
        pass  # not cached / transformers absent: fall through to presets
    name = identifier.split("/")[-1].lower()
    if name in PRESETS:
        return PRESETS[name]
    # cbas_tpu's logger (console + UI queue), imported only here: resolving a
    # preset by its own name, as the device path does, imports nothing of
    # cbas_tpu.
    from cbas_tpu_torch.utils.logging import log_message

    for key in sorted(PRESETS, key=len, reverse=True):
        if key in name:
            log_message(
                f"Encoder '{identifier}' has no local config; assuming "
                f"the '{key}' preset architecture from its name. If the "
                "checkpoint is a variant (plus/gated), embeddings will "
                "be wrong — provide the checkpoint's config.json.",
                "WARN",
            )
            return PRESETS[key]
    if "dinov3" in name:
        log_message(
            f"Unknown encoder '{identifier}': assuming dinov3-vitb16 preset.", "WARN"
        )
        return PRESETS["dinov3-vitb16"]
    log_message(
        f"Unknown encoder '{identifier}': assuming dinov2-with-registers-base.", "WARN"
    )
    return PRESETS["dinov2-with-registers-base"]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _ln(params: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in fp32: single-pass E[x^2] - mean^2 variance on bf16
    activations, two-pass on fp32, as the JAX package's default;
    ``CBAS_LN_TWO_PASS`` set (to anything non-empty) forces the two-pass form
    on bf16 too, as it does there."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    if x.dtype == torch.bfloat16 and not os.environ.get("CBAS_LN_TWO_PASS"):
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params[f"{name}.weight"].float() + params[f"{name}.bias"].float()).to(x.dtype)


def _dense(params: Params, name: str, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"] if bias else None)


def _dense_reduce(
    params: Params, name: str, x: torch.Tensor, bias: bool, full_in: int
) -> torch.Tensor:
    """Down-projection whose input dim may be TP-sharded: matmul over the
    local columns, psum the partial iff the weight is a shard of ``full_in``,
    then add the replicated bias exactly once."""
    if params[f"{name}.weight"].shape[1] == full_in:
        return _dense(params, name, x, bias)
    y = _maybe_psum(_dense(params, name, x, False))
    return y + params[f"{name}.bias"] if bias else y


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, C*p*p) patch vectors ordered (c, dy, dx),
    floored like torch Conv2d."""
    B, C, H, W = x.shape
    hp, wp = H // patch, W // patch
    x = x[:, :, : hp * patch, : wp * patch]
    x = x.reshape(B, C, hp, patch, wp, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, hp * wp, C * patch * patch)


def _full_rope_tables(rope: Rope, n_prefix: int) -> Rope:
    """Extend patch-only cos/sin with identity rows for the CLS/register
    prefix, so RoPE is one elementwise expression over all tokens."""
    cos, sin = rope
    hd = cos.shape[-1]
    cos_full = torch.cat([cos.new_ones((n_prefix, hd)), cos], dim=0)
    sin_full = torch.cat([sin.new_zeros((n_prefix, hd)), sin], dim=0)
    return cos_full, sin_full


def _attn_param_table(cfg: ViTConfig, prefix: str):
    """(qkv names, qkv bias flags, out name, out bias) for the variant."""
    if cfg.variant == "dinov2":
        return (
            [f"{prefix}.attention.attention.{p}" for p in ("query", "key", "value")],
            [True, True, True],
            f"{prefix}.attention.output.dense",
            True,
        )
    return (
        [f"{prefix}.attention.{p}" for p in ("q_proj", "k_proj", "v_proj")],
        [cfg.query_bias, cfg.key_bias, cfg.value_bias],
        f"{prefix}.attention.o_proj",
        cfg.proj_bias,
    )


def _attention(
    params: Params, prefix: str, x: torch.Tensor, cfg: ViTConfig, rope: Optional[Rope]
) -> torch.Tensor:
    """Full attention, routed as the JAX package routes it
    (``cbas_tpu/models/vit.py::_attention``) on the local head count, read
    off the q weight (under tensor parallelism a shard holds H / model of
    the heads):

    - 64-wide heads, an even local head count and :func:`fa.use_fat_attention`:
      the flat projections feed K1 directly and its output feeds the
      out-projection;
    - 64-wide heads and an even local head count otherwise: head-pair packed
      (B, H/2, N, 128) views of the projections, K2;
    - any other head dim, or an odd local head count: head-major
      (B, H, N, d) views of the projections, K3.

    No route falls back to another. ``rope`` is the full-length
    (N, head_dim) table pair or None. A sharded out-projection's partial is
    summed over the model axis before its bias is added (:func:`_dense_reduce`)."""
    B, N, _ = x.shape
    hd = cfg.head_dim
    names, biases, out_name, out_bias = _attn_param_table(cfg, prefix)
    H = params[f"{names[0]}.weight"].shape[0] // hd  # the local head count
    q, k, v = (_dense(params, n, x, b) for n, b in zip(names, biases))
    cos, sin = rope if rope is not None else (None, None)
    scale = hd ** -0.5
    packed = hd == fa.HEAD_DIM and H % 2 == 0
    if packed and fa.use_fat_attention():
        ctx = fa.fused_attention_fat(q, k, v, scale, rope_cos=cos, rope_sin=sin)
        return _dense_reduce(params, out_name, ctx, out_bias, cfg.hidden_size)

    if packed:
        def pairs(t):  # (B, N, H*64) -> a (B, H/2, N, 128) view, no copy
            return t.view(B, N, H // 2, 2 * hd).transpose(1, 2)

        ctx = fa.fused_attention_packed(pairs(q), pairs(k), pairs(v), scale, rope_cos=cos,
                                        rope_sin=sin)
    else:
        def heads(t):  # (B, N, H*hd) -> a (B, H, N, hd) view, no copy
            return t.view(B, N, H, hd).transpose(1, 2)

        ctx = fa.fused_attention(heads(q), heads(k), heads(v), scale, rope_cos=cos, rope_sin=sin)
    # The out-projection contracts over (heads, head dim) in the order the
    # flat layout holds them, so the context goes back to (B, N, H*hd): a
    # view on both routes, since K2 and K3 write with q's strides (K3 copies
    # only for the head dims it reads through a pad, fused_attention says
    # which).
    ctx = ctx.transpose(1, 2).reshape(B, N, H * hd)
    return _dense_reduce(params, out_name, ctx, out_bias, cfg.hidden_size)


def _attention_cls(
    params: Params, prefix: str, h: torch.Tensor, cfg: ViTConfig, rope: Optional[Rope]
) -> torch.Tensor:
    """Attention output for the CLS row only: one query row, K/V over every
    token, over the local heads. Plain torch: a (B, H, 1, N) score tensor is
    too small for a kernel to matter."""
    B, N, _ = h.shape
    hd = cfg.head_dim
    names, biases, out_name, out_bias = _attn_param_table(cfg, prefix)
    H = params[f"{names[0]}.weight"].shape[0] // hd  # the local head count

    def heads(t):
        return t.reshape(B, t.shape[1], H, hd).transpose(1, 2)  # (B, H, n, hd)

    q = heads(_dense(params, names[0], h[:, :1], biases[0]))  # CLS row; its RoPE is identity
    k = heads(_dense(params, names[1], h, biases[1]))
    v = heads(_dense(params, names[2], h, biases[2]))
    if rope is not None:
        cos, sin = (t.to(k.dtype) for t in rope)
        k = k * cos + fa.rotate_half(k) * sin
    s = (q @ k.transpose(-1, -2)).float() * (hd ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    ctx = (p @ v).transpose(1, 2).reshape(B, 1, H * hd)
    return _dense_reduce(params, out_name, ctx, out_bias, cfg.hidden_size)


def _mlp(params: Params, prefix: str, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """The block's MLP. Its down-projection may be TP-sharded on the
    intermediate dim (:func:`_dense_reduce`); SwiGLU stays replicated."""
    approx = "tanh" if cfg.gelu_approximate else "none"
    inter = cfg.intermediate_size
    if cfg.variant == "dinov2":
        if cfg.use_swiglu_ffn:
            x1, x2 = _dense(params, f"{prefix}.mlp.weights_in", x).chunk(2, dim=-1)
            return _dense(params, f"{prefix}.mlp.weights_out", F.silu(x1) * x2)
        h = F.gelu(_dense(params, f"{prefix}.mlp.fc1", x), approximate=approx)
        return _dense_reduce(params, f"{prefix}.mlp.fc2", h, True, inter)
    if cfg.use_gated_mlp:
        g = F.gelu(_dense(params, f"{prefix}.mlp.gate_proj", x, cfg.mlp_bias), approximate=approx)
        u = _dense(params, f"{prefix}.mlp.up_proj", x, cfg.mlp_bias)
        return _dense_reduce(params, f"{prefix}.mlp.down_proj", g * u, cfg.mlp_bias, inter)
    h = F.gelu(_dense(params, f"{prefix}.mlp.up_proj", x, cfg.mlp_bias), approximate=approx)
    return _dense_reduce(params, f"{prefix}.mlp.down_proj", h, cfg.mlp_bias, inter)


def _block(
    params: Params, prefix: str, x: torch.Tensor, cfg: ViTConfig, rope: Optional[Rope]
) -> torch.Tensor:
    h = _ln(params, f"{prefix}.norm1", x, cfg.layer_norm_eps)
    x = x + _attention(params, prefix, h, cfg, rope) * params[f"{prefix}.layer_scale1.lambda1"]
    h = _ln(params, f"{prefix}.norm2", x, cfg.layer_norm_eps)
    return x + _mlp(params, prefix, h, cfg) * params[f"{prefix}.layer_scale2.lambda1"]


def _block_cls(
    params: Params, prefix: str, x: torch.Tensor, cfg: ViTConfig, rope: Optional[Rope]
) -> torch.Tensor:
    """Final block specialised to the CLS row: K/V span all tokens, but
    q/out-proj/MLP/residual run on token 0 alone. Returns (B, 1, D)."""
    h = _ln(params, f"{prefix}.norm1", x, cfg.layer_norm_eps)
    h = _attention_cls(params, prefix, h, cfg, rope)
    x0 = x[:, :1] + h * params[f"{prefix}.layer_scale1.lambda1"]
    h = _ln(params, f"{prefix}.norm2", x0, cfg.layer_norm_eps)
    return x0 + _mlp(params, prefix, h, cfg) * params[f"{prefix}.layer_scale2.lambda1"]


# ---------------------------------------------------------------------------
# Position encodings
# ---------------------------------------------------------------------------

def rope_tables(cfg: ViTConfig, grid_h: int, grid_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """DINOv3 RoPE cos/sin for a (grid_h, grid_w) patch grid (numpy, fp32):
    patch-centre coords normalised to [-1, 1], angles = 2*pi*coords x
    inv_freq, halves tiled."""
    hd = cfg.head_dim
    inv_freq = 1.0 / cfg.rope_theta ** np.arange(0, 1, 4 / hd, dtype=np.float32)
    ch = (np.arange(0.5, grid_h, dtype=np.float32) / grid_h) * 2.0 - 1.0
    cw = (np.arange(0.5, grid_w, dtype=np.float32) / grid_w) * 2.0 - 1.0
    coords = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1).reshape(-1, 2)
    angles = 2.0 * math.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = angles.reshape(angles.shape[0], -1)
    angles = np.tile(angles, 2)
    return np.cos(angles), np.sin(angles)


def resample_pos_embed(pos: np.ndarray, grid_h: int, grid_w: int) -> np.ndarray:
    """Resize a DINOv2 ``(1, 1 + S*S, D)`` position table (CLS first) to a new
    grid with antialiased bicubic, as HF ``interpolate_pos_encoding``.
    Returns ``(1, 1 + grid_h*grid_w, D)`` float32."""
    pos = np.asarray(pos, np.float32)
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    s = int(round(patch_pos.shape[1] ** 0.5))
    if (s, s) == (grid_h, grid_w):
        return pos
    t = torch.from_numpy(patch_pos.reshape(1, s, s, -1).copy()).permute(0, 3, 1, 2)
    t = F.interpolate(
        t, size=(grid_h, grid_w), mode="bicubic", align_corners=False, antialias=True
    )
    out = t.permute(0, 2, 3, 1).numpy()
    return np.concatenate([cls_pos, out.reshape(1, grid_h * grid_w, -1)], axis=1)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _assemble_embeddings(
    params: Params, tokens: torch.Tensor, cfg: ViTConfig, pos_embed: Optional[torch.Tensor]
) -> torch.Tensor:
    """Projected patch tokens -> full sequence: dinov2 is CLS, registers,
    patches with the position table added before the registers go in;
    dinov3 is CLS, registers, patches."""
    B, _, D = tokens.shape
    cls_tok = params["embeddings.cls_token"].expand(B, 1, D)
    if cfg.variant == "dinov2":
        x = torch.cat([cls_tok, tokens], dim=1)
        if pos_embed is None:
            pos_embed = params["embeddings.position_embeddings"]
        x = x + pos_embed
        if cfg.num_register_tokens:
            regs = params["embeddings.register_tokens"].expand(B, -1, D)
            x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        return x
    if not cfg.num_register_tokens:
        return torch.cat([cls_tok, tokens], dim=1)
    regs = params["embeddings.register_tokens"].expand(B, -1, D)
    return torch.cat([cls_tok, regs, tokens], dim=1)


def vit_forward_from_tokens(
    params: Params,
    tokens: torch.Tensor,
    cfg: ViTConfig,
    pos_embed: Optional[torch.Tensor] = None,
    rope: Optional[Rope] = None,
    cls_only: bool = False,
) -> torch.Tensor:
    """Run the transformer over already-projected patch tokens (B, N, D).

    ``rope`` (dinov3) is the patch-only (cos, sin) pair of :func:`rope_tables`
    as fp32 tensors. ``cls_only=True`` returns just the CLS row (B, 1, D) and
    runs the final block on that row alone (K/V still span all tokens).
    """
    x = _assemble_embeddings(params, tokens, cfg, pos_embed)
    if cfg.variant == "dinov2":
        layer_prefix, final_ln, block_rope = "encoder.layer", "layernorm", None
    else:
        layer_prefix, final_ln = "layer", "norm"
        if rope is None:
            raise ValueError("dinov3 requires rope tables (see rope_tables())")
        block_rope = _full_rope_tables(rope, cfg.num_prefix_tokens)

    last = cfg.num_layers - 1
    for i in range(last if cls_only else cfg.num_layers):
        x = _block(params, f"{layer_prefix}.{i}", x, cfg, block_rope)
    if cls_only:
        x = _block_cls(params, f"{layer_prefix}.{last}", x, cfg, block_rope)
    return _ln(params, final_ln, x, cfg.layer_norm_eps)


def vit_forward(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    pos_embed: Optional[torch.Tensor] = None,
    rope: Optional[Rope] = None,
) -> torch.Tensor:
    """Encode images: (B, 3, H, W) -> last hidden state (B, N_tokens, D).
    Token 0 is CLS."""
    if cfg.variant == "dinov2":
        w = params["embeddings.patch_embeddings.projection.weight"]
        bias = params["embeddings.patch_embeddings.projection.bias"]
    else:
        w = params["embeddings.patch_embeddings.weight"]
        bias = params["embeddings.patch_embeddings.bias"]
    tokens = F.linear(patchify(pixel_values, cfg.patch_size), w.reshape(w.shape[0], -1), bias)
    if cfg.variant == "dinov3" and rope is None:
        grid = (pixel_values.shape[2] // cfg.patch_size, pixel_values.shape[3] // cfg.patch_size)
        rope = tuple(torch.from_numpy(t).to(pixel_values.device) for t in rope_tables(cfg, *grid))
    return vit_forward_from_tokens(params, tokens, cfg, pos_embed, rope)


def cls_attention_map(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    pos_embed: Optional[torch.Tensor] = None,
    rope: Optional[Rope] = None,
) -> torch.Tensor:
    """Head-averaged last-layer attention of the CLS token over patch tokens,
    (B, grid_h, grid_w) in fp32: the heatmap ``tools/compare_encoders.py``
    draws to compare backbones.

    ``params`` holds the full checkpoint (the raw patch-projection weight
    and, for dinov2, the position table included) in ``pixel_values``'
    dtype and device. The first ``num_layers - 1`` blocks run through
    :func:`_block`, so their attention takes the fused kernels' routes; the
    last block's CLS row is opened here: LayerNorm, the q and k
    projections, RoPE, then an fp32 softmax of the scaled scores."""
    B, _, H, W = pixel_values.shape
    grid = (H // cfg.patch_size, W // cfg.patch_size)
    if cfg.variant == "dinov2":
        patch, layer_prefix, block_rope = "embeddings.patch_embeddings.projection", "encoder.layer", None
        if pos_embed is None:
            pos = params["embeddings.position_embeddings"].detach().float().cpu().numpy()
            pos_embed = torch.from_numpy(resample_pos_embed(pos, *grid)).to(
                pixel_values.device, pixel_values.dtype)
    else:
        patch, layer_prefix = "embeddings.patch_embeddings", "layer"
        if rope is None:
            rope = tuple(torch.from_numpy(t).to(pixel_values.device) for t in rope_tables(cfg, *grid))
        block_rope = _full_rope_tables(rope, cfg.num_prefix_tokens)
    w = params[f"{patch}.weight"]
    tokens = F.linear(patchify(pixel_values, cfg.patch_size), w.reshape(w.shape[0], -1),
                      params[f"{patch}.bias"])
    x = _assemble_embeddings(params, tokens, cfg, pos_embed)
    for i in range(cfg.num_layers - 1):
        x = _block(params, f"{layer_prefix}.{i}", x, cfg, block_rope)

    prefix = f"{layer_prefix}.{cfg.num_layers - 1}"
    h = _ln(params, f"{prefix}.norm1", x, cfg.layer_norm_eps)
    N, Hh, hd = h.shape[1], cfg.num_heads, cfg.head_dim
    names, biases, _, _ = _attn_param_table(cfg, prefix)
    q, k = (_dense(params, n, h, b).reshape(B, N, Hh, hd).transpose(1, 2)
            for n, b in zip(names[:2], biases[:2]))
    if block_rope is not None:
        # The real forward's identity-prefix tables and rotate-half, not a
        # private copy, so a RoPE fix cannot desynchronize this probe.
        cos, sin = (t.to(q.dtype) for t in block_rope)
        q = q * cos + fa.rotate_half(q) * sin
        k = k * cos + fa.rotate_half(k) * sin
    scores = torch.einsum("bhd,bhkd->bhk", q[:, :, 0, :], k) * (hd ** -0.5)
    weights = torch.softmax(scores.float(), dim=-1)
    patch_attn = weights[:, :, cfg.num_prefix_tokens:].mean(dim=1)  # head-averaged
    return patch_attn.reshape(B, *grid)


def cls_embeddings(
    params: Params,
    pixel_values: torch.Tensor,
    cfg: ViTConfig,
    pos_embed: Optional[torch.Tensor] = None,
    rope: Optional[Rope] = None,
) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D) CLS tokens (the pipeline's frame embedding)."""
    return vit_forward(params, pixel_values, cfg, pos_embed, rope)[:, 0, :]


# ---------------------------------------------------------------------------
# Initialisation (offline/self-trained encoders, tests, the GPU smoke run)
# ---------------------------------------------------------------------------

def vit_param_shapes(cfg: ViTConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter of ``cfg`` as name -> (shape, init), init one of
    "normal" (trunc-normal 0.02), "zeros" or "ones"."""
    D, p = cfg.hidden_size, cfg.patch_size
    spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def dense(name: str, fan_in: int, fan_out: int, bias: bool = True) -> None:
        spec[f"{name}.weight"] = ((fan_out, fan_in), "normal")
        if bias:
            spec[f"{name}.bias"] = ((fan_out,), "zeros")

    def ln(name: str) -> None:
        spec[f"{name}.weight"] = ((D,), "ones")
        spec[f"{name}.bias"] = ((D,), "zeros")

    spec["embeddings.cls_token"] = ((1, 1, D), "normal")
    if cfg.num_register_tokens:
        spec["embeddings.register_tokens"] = ((1, cfg.num_register_tokens, D), "zeros")
    patch = (
        "embeddings.patch_embeddings.projection" if cfg.variant == "dinov2"
        else "embeddings.patch_embeddings"
    )
    spec[f"{patch}.weight"] = ((D, 3, p, p), "normal")
    spec[f"{patch}.bias"] = ((D,), "zeros")
    if cfg.variant == "dinov2":
        n_pos = (cfg.image_size // p) ** 2 + 1
        spec["embeddings.position_embeddings"] = ((1, n_pos, D), "normal")

    for i in range(cfg.num_layers):
        pref = f"encoder.layer.{i}" if cfg.variant == "dinov2" else f"layer.{i}"
        ln(f"{pref}.norm1")
        ln(f"{pref}.norm2")
        spec[f"{pref}.layer_scale1.lambda1"] = ((D,), "ones")
        spec[f"{pref}.layer_scale2.lambda1"] = ((D,), "ones")
        if cfg.variant == "dinov2":
            for n in ("query", "key", "value"):
                dense(f"{pref}.attention.attention.{n}", D, D)
            dense(f"{pref}.attention.output.dense", D, D)
            if cfg.use_swiglu_ffn:
                dense(f"{pref}.mlp.weights_in", D, 2 * cfg.intermediate_size)
                dense(f"{pref}.mlp.weights_out", cfg.intermediate_size, D)
            else:
                dense(f"{pref}.mlp.fc1", D, cfg.intermediate_size)
                dense(f"{pref}.mlp.fc2", cfg.intermediate_size, D)
        else:
            dense(f"{pref}.attention.q_proj", D, D, cfg.query_bias)
            dense(f"{pref}.attention.k_proj", D, D, cfg.key_bias)
            dense(f"{pref}.attention.v_proj", D, D, cfg.value_bias)
            dense(f"{pref}.attention.o_proj", D, D, cfg.proj_bias)
            if cfg.use_gated_mlp:
                dense(f"{pref}.mlp.gate_proj", D, cfg.intermediate_size, cfg.mlp_bias)
            dense(f"{pref}.mlp.up_proj", D, cfg.intermediate_size, cfg.mlp_bias)
            dense(f"{pref}.mlp.down_proj", cfg.intermediate_size, D, cfg.mlp_bias)
    ln("layernorm" if cfg.variant == "dinov2" else "norm")
    return spec


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """N(0, 1) truncated to [-2, 2] by redrawing, rescaled to std ``std``
    (jax.nn.initializers.truncated_normal's convention)."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return x * np.float32(std / 0.87962566103423978)


def init_vit_params(seed: int, cfg: ViTConfig) -> Dict[str, np.ndarray]:
    """HF-style random init from ``numpy.random.default_rng(seed)``:
    trunc-normal(0.02) weights, zero biases, layer scale 1. Float32 numpy."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, (shape, kind) in vit_param_shapes(cfg).items():
        if kind == "normal":
            out[name] = _trunc_normal(rng, shape, 0.02)
        else:
            out[name] = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
    return out
