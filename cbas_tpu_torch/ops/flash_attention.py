"""Fused attention in the three layouts of the JAX package.

Port of ``cbas_tpu/ops/flash_attention.py``'s three Pallas entries, with
their names and argument order (the TPU-only ``block_q``, ``interpret`` and
``pvt`` arguments dropped):

- :func:`fused_attention_fat` (K1): flat (B, N, H*64), straight out of the
  projection matmul and into the out-projection, so no transpose surrounds
  the call.
- :func:`fused_attention_packed` (K2): head-pair packed (B, H/2, N, 128),
  two 64-wide heads side by side on the last dim.
- :func:`fused_attention` (K3): head-major (B, H, N, d), any d on the
  card. Its bf16 bodies are built at 64, 96, 128, 160, 192, 224 and 256
  (BF16_HEAD_DIMS), its fp32 ones at 64, 128, 192 and 256
  (HEADMAJOR_HEAD_DIMS), and a head of width d up to 256 runs at the next
  of those (:func:`headmajor_width`), its tensor maps at d (the columns
  beyond read as zeros); a head above 256 runs a body that takes d at run
  time (the wide body in bf16, the fp32 slices body in fp32). Every bf16
  head is read in place: up to 192 one whose rows are no 32-byte multiple
  (d % 16 != 0), from 193 to 256 one whose rows are no 16-byte multiple
  (d % 8 != 0), goes through one staging launch first
  (:func:`bf16_stage_reference` is its plain version), which also ropes an
  odd d. fp32 still copies one case: a width up to 256 that is no
  multiple of 4 runs zero-padded to the next multiple of 4
  (:func:`pad_head_dim`), roped here first at an odd d with tables
  (rotate-half's pairing of an odd d survives no pad).

All three compute one function per head: optional rotate-half RoPE from fp32
(N, d) tables, the scale on the q side, keys at or beyond ``n_valid`` masked,
exact fp32 softmax, output in q's dtype.

All three take strided views as well as contiguous tensors: q, k and v with
one set of strides (``_check_strides``), such as the column blocks
``qkv[..., :D]``, ``qkv[..., D:2D]`` and ``qkv[..., 2D:]`` of one fused
(B, N, 3D) q|k|v projection (the TPU kernel
``benchmarks/attn_probes/probe22_qkvfused_256.py::make_qkv_kernel`` read its
q, k and v at those offsets of one row), and their head-pair or head-major
views (``t.view(B, N, H // 2, 128).transpose(1, 2)``,
``t.view(B, N, H, d).transpose(1, 2)``). The output is allocated dense in
q's dim order (:func:`_dense_like`): contiguous (B, N, H*64) for K1,
``empty(B, N, H or H/2, w).transpose(1, 2)`` for K2 and K3 on such views, so
the model's ``ctx.transpose(1, 2).reshape(B, N, H*d)`` is a view, and the
contiguous layout itself for contiguous inputs. The kernels read q, k and v
through q's strides and write the output through its own; the RoPE scratch
of the Hopper and wide bodies lies as the output does.

- On a CUDA tensor each wrapper launches its hand-written kernel
  (``csrc/attention_{fat,packed,headmajor}.cu``) or raises. None falls back.
- On a CPU tensor it runs its plain PyTorch version
  (``attention_{fat,packed,headmajor}_reference``).

Six bodies serve the three entries (:func:`attention_body`):

- "sm90": bfloat16 at head dim 64 (K1, K2) and in K3 at every d up to 192
  (at the next of 64, 96, 128, 160 and 192) takes the Hopper body
  (``csrc/attention_sm90.cuh``: TMA ring, wgmma, RoPE once per token and
  head, tensor maps built from the tensors' strides, each product at the
  built width, so 96 and 160 run 3/4 and 5/6 of the products of 128 and
  192; at d % 16 != 0 over scratch that a staging launch fills, O written
  with plain stores);
- "sm90_ws": bfloat16 in K3 from 193 to 256 (at 224 or 256) takes the
  two-consumer body (``csrc/attention_sm90_ws.cuh``: the same maps, RoPE
  and staging, with a producer warpgroup handing its registers by
  ``setmaxnreg`` to two consumer warpgroups of 64 query rows that take
  turns on the tensor cores, 128 rows a block; rows off 32 bytes, d % 16
  == 8, on maps at d, only d % 8 != 0 staged): it ran 20-34% faster at
  every timed row at 256, and at 192 tied or lost (PERF.md), so 129-192
  stay on "sm90";
- "sm90_f32": float32 at head dim 64 (K1, K2, K3) and, in K3, at every
  multiple of 4 up to 128 (at 64 or 128, maps at d) takes its fp32
  counterpart (``csrc/attention_sm90_tf32.cuh``: the same ring and maps,
  every product as three TF32 products on wgmma, "3xTF32", with K and V
  split, roped and V transposed once a call by a prologue into scratch this
  module allocates; :func:`tf32_prologue_reference` is the prologue's plain
  version, bit for bit);
- "sm90_f32_wide": float32 in K3 at every multiple of 4 from 132 to 256 (at
  192 or 256, maps at d) takes its wide form
  (``csrc/attention_sm90_tf32_wide.cuh``: the same arithmetic and prologue,
  two consumer warpgroups, each owning half of d, Q split in registers);
- "sm90_f32_slices": float32 in K3 at any d above 256 takes its slices body
  (``csrc/attention_sm90_tf32_slices.cuh``: the same arithmetic, O in
  384-column slices, two consumer warpgroups each forming q.k^T over half
  of d's atoms, Q staged without the TMA, the prologue at d rounded up to
  64);
- "wide": K3's bf16 heads above 256 take the wide body
  (``csrc/attention_wide.cuh``: O in 384-column slices, the scores formed
  once a slice, on wgmma with two consumer warpgroups).

``launches`` (K1), ``launches_packed`` (K2) and ``launches_headmajor`` (K3)
count kernel launches and nothing else, so a run can show which kernels its
main path went through; ``launches_headmajor_by_dim`` splits K3's by the
head dim the kernel ran at (the built width, for a head it runs padded),
``launches_sm90`` counts those of them all that ran the Hopper body, as the
C entry reports it (``launches_sm90_by_kernel`` by entry),
``launches_sm90_f32`` (``launches_sm90_f32_by_kernel``) those that ran the
fp32 Hopper body, ``launches_sm90_f32_wide`` those of K3 that ran its wide
form, ``launches_sm90_f32_slices`` those that ran its slices body,
``launches_tf32_prologue`` the launches of their prologue (those the
C entries report queuing, one with each of those, and one a
:func:`tf32_prologue` call),
``launches_wide`` those of K3 that ran the wide body, ``launches_sm90_ws``
those of K3 that ran the two-consumer body, and
``launches_stage`` the launches of bf16's staging pass (one with each K3
call where :func:`headmajor_staged` says so, as the C entry reports them,
and one a :func:`bf16_stage` call). The shards of a
device mesh launch from threads of their own, so every count is updated
under one lock.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from typing import Optional

import torch

HEAD_DIM = 64       # K1's and K2's head width
# The head dims K3's fp32 bodies are built at up to 256: a head of width d
# runs at the next of them, its tensor maps at d; above 256, at d itself.
HEADMAJOR_HEAD_DIMS = (64, 128, 192, 256)
# The same for K3's bf16 bodies (csrc/attention_sm90.cuh's kBf16Widths): 64
# to 192 the Hopper body, 224 and 256 the two-consumer body.
BF16_HEAD_DIMS = (64, 96, 128, 160, 192, 224, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0            # K1, fused_attention_fat
launches_packed = 0     # K2, fused_attention_packed
launches_headmajor = 0  # K3, fused_attention
launches_headmajor_by_dim: dict = {}  # K3's launches by head dim
launches_sm90 = 0       # launches of any entry that ran the Hopper body
launches_sm90_by_kernel: dict = {}  # the same, by entry ("attention_fat", ...)
launches_sm90_f32 = 0   # launches of any entry that ran the fp32 Hopper body
launches_sm90_f32_by_kernel: dict = {}  # the same, by entry
launches_sm90_f32_wide = 0  # K3's launches that ran its wide form (d 132-256)
launches_sm90_f32_slices = 0  # K3's launches that ran its slices body (fp32, d > 256)
launches_tf32_prologue = 0  # launches of those bodies' prologue (csrc split_kv, split_kv_wide)
launches_wide = 0       # K3's launches that ran the wide body (bf16, d > 256)
launches_sm90_ws = 0    # K3's launches that ran the two-consumer body (bf16, d 193-256)
launches_stage = 0      # launches of bf16's staging pass (csrc stage_rows)
_count_lock = threading.Lock()  # shard threads launch concurrently

TF32_BODIES = ("sm90_f32", "sm90_f32_wide", "sm90_f32_slices")
_BODIES = {1: "sm90", 2: "wide", 3: "sm90_f32", 4: "sm90_f32_wide",
           5: "sm90_f32_slices", 6: "sm90_ws"}  # *body codes
BF16_BODIES = ("sm90", "sm90_ws")  # the bf16 bodies up to 256 (RoPE prologue, staging)
# The rows of bf16's staging scratch hold d rounded up to this (32 bytes):
# on tensor maps whose rows, or whose last column, end off a 32-byte
# boundary the Hopper body ran 1.2-2.3x its time (PERF.md), so a bf16 head
# at a d that is no multiple of it is staged.
STAGE_ROW_UNIT = 16
# The two-consumer body (bf16 from 193 to 256) reads rows of any whole
# number of 16-byte units in place (csrc/attention_sm90_ws.cuh's kRowUnit):
# only a d that is no multiple of it is staged there.
WS_ROW_UNIT = 8
# The fp32 Hopper body's key tile (csrc/attention_sm90_tf32.cuh, kKeys):
# its scratch holds n_valid keys rounded up to it (tf32_scratch_keys).
TF32_KEY_TILE = 32
# V^T's order of the keys of a group of 8 (the body's kSlotOfKey): position
# p holds key TF32_KEY_ORDER[p], so that P's accumulator registers are p.V's
# A fragments as they stand.
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# O's columns a block of the fp32 slices body owns (csrc/
# attention_sm90_tf32_slices.cuh): the scores are formed once a slice.
TF32_SLICE_COLS = 384


def tf32_width(d: int) -> int:
    """The width of an fp32 Hopper body's prologue scratch at head dim d: up
    to 256 the width the body runs at, its maps at d, the next of 64 and 128
    ("sm90_f32") and 192 and 256 ("sm90_f32_wide"); above, d rounded up to
    64 ("sm90_f32_slices", which runs at d itself)."""
    if d > 256:
        return -(-d // 64) * 64
    return next(w for w in HEADMAJOR_HEAD_DIMS if w >= d)


def attention_body(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The body entry ``kernel`` (``attention_fat``, ``attention_packed`` or
    ``attention_headmajor``) runs for ``dtype`` and ``head_dim``: "sm90" (the
    Hopper body: bfloat16 at 64, and in K3 at every d up to 192), "sm90_ws"
    (the two-consumer body: bfloat16 in K3 from 193 to 256), "sm90_f32"
    (its fp32 counterpart: float32 at 64, and in K3 at every d up to 128),
    "sm90_f32_wide" (its wide form: float32 in K3 from 129 to 256),
    "sm90_f32_slices" (its slices body: float32 in K3 above 256) or "wide"
    (K3's bf16 heads above 256). fp32 runs a d that is no multiple of 4
    padded to one, on the body of that width. The C entries route by the
    same rule and report the body they ran. Raises ``ValueError`` for what
    no body takes: another dtype, or K1 and K2 at a d other than 64."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"no attention body takes {dtype}")
    f32 = dtype == torch.float32
    if kernel == "attention_headmajor" and head_dim > 0:
        if head_dim > 256:
            return "sm90_f32_slices" if f32 else "wide"
        if not f32:
            return "sm90" if head_dim <= 192 else "sm90_ws"
        return "sm90_f32" if head_dim <= 128 else "sm90_f32_wide"
    if kernel in ("attention_fat", "attention_packed") and head_dim == HEAD_DIM:
        return "sm90_f32" if f32 else "sm90"
    raise ValueError(f"{kernel} takes no head dim {head_dim}")


def use_fat_attention() -> bool:
    """Whether 64-wide heads take the flat layout (K1): yes unless
    ``CBAS_ATTN_FAT`` is set to one of the JAX package's falsy spellings."""
    env = os.environ.get("CBAS_ATTN_FAT")
    if env is not None:
        return env.lower() not in ("", "0", "false", "no", "off")
    return True


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    """RoPE's partner term: (-x2, x1) for x = (x1, x2) split in halves."""
    h = t.shape[-1] // 2
    return torch.cat([-t[..., h:], t[..., :h]], dim=-1)


def _attend(q, k, v, scale, nv, rope_cos, rope_sin, dtype) -> torch.Tensor:
    """The kernels' function on head-major (B, H, N, d) tensors, in fp32.

    Values are rounded to ``dtype`` where the kernels round them: roped and
    scaled q, roped k, and p before p.V (the row sum stays fp32). For fp32
    that rounding is a no-op. Returns fp32."""
    N = q.shape[2]
    qh, kh, vh = q.float(), k.float(), v.float()
    if rope_cos is not None:
        cos, sin = rope_cos.float(), rope_sin.float()
        qh = qh * cos + rotate_half(qh) * sin
        kh = kh * cos + rotate_half(kh) * sin
    qh = (qh * scale).to(dtype).float()
    kh = kh.to(dtype).float()
    live = torch.arange(N, device=q.device) < nv
    kh = torch.where(live[:, None], kh, 0.0)  # dead rows' NaN/Inf bits cannot leak
    vh = torch.where(live[:, None], vh, 0.0)
    s = torch.where(live, qh @ kh.transpose(-1, -2), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p.to(dtype).float() @ vh) / p.sum(dim=-1, keepdim=True)


def tf32_scratch_keys(n_valid: int) -> int:
    """The keys a head holds in the fp32 Hopper body's scratch: ``n_valid``
    rounded up to the key tile (the rows past it are zeros)."""
    return -(-n_valid // TF32_KEY_TILE) * TF32_KEY_TILE


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 fraction bits, to nearest, ties away
    from zero), the low 13 bits zero: the kernel's integer operations on the
    bits, ``(bits + 0x1000) & ~0x1fff``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """fp32 ``x`` as (hi, lo), both TF32 values: hi rounded from x, lo from
    x - hi (exact in fp32), so x - hi - lo is below 2^-22 |x| in the normal
    range. The fp32 Hopper body's split, bit for bit."""
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def tf32_prologue_reference(
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fp32 Hopper bodies' prologue on
    head-major (B, H, N, d) fp32 k and v, at the ``width`` >= d the body
    runs at (d by default): a (4, B, H, n_keys, width) fp32 tensor (n_keys =
    :func:`tf32_scratch_keys`), its planes K_hi, K_lo (k roped with the
    (N, d) tables, rotate-half at d, then split: :func:`tf32_split`) and
    V^T_hi, V^T_lo, each of those two laid out (B, H, width, n_keys): v
    transposed, the keys of each group of 8 in TF32_KEY_ORDER, then split.
    Keys at or beyond ``n_valid`` and columns (V^T rows) from d to ``width``
    are zeros in every plane. The kernel writes the same bits."""
    B, H, N, d = k.shape
    w = d if width is None else width
    nv = N if n_valid is None else n_valid
    n_keys = tf32_scratch_keys(nv)
    kh = k[:, :, :nv].float()
    if rope_cos is not None:
        cos, sin = rope_cos[:nv].float(), rope_sin[:nv].float()
        kh = kh * cos + rotate_half(kh) * sin
    out = torch.zeros(4, B, H, n_keys, w, dtype=torch.float32, device=k.device)
    out[0, :, :, :nv, :d], out[1, :, :, :nv, :d] = tf32_split(kh)
    vz = torch.zeros(B, H, n_keys, w, dtype=torch.float32, device=v.device)
    vz[:, :, :nv, :d] = v[:, :, :nv]
    order = torch.tensor([8 * (i // 8) + TF32_KEY_ORDER[i % 8] for i in range(n_keys)],
                         device=v.device)
    hi, lo = tf32_split(vz[:, :, order].transpose(-1, -2))
    out[2].view(B, H, w, n_keys).copy_(hi)
    out[3].view(B, H, w, n_keys).copy_(lo)
    return out


def attention_headmajor_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3 on head-major (B, H, N, d) tensors."""
    nv = q.shape[2] if n_valid is None else n_valid
    return _attend(q, k, v, scale, nv, rope_cos, rope_sin, q.dtype).to(q.dtype)


def attention_packed_reference(
    q2: torch.Tensor,
    k2: torch.Tensor,
    v2: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2 on head-pair packed (B, G, N, 2d) tensors."""
    B, G, N, dd = q2.shape
    d = dd // 2

    def heads(t):  # (B, G, N, 2d) -> (B, 2G, N, d), contiguous whatever t's strides
        return t.reshape(B, G, N, 2, d).transpose(2, 3).reshape(B, 2 * G, N, d).contiguous()

    nv = N if n_valid is None else n_valid
    out = _attend(heads(q2), heads(k2), heads(v2), scale, nv, rope_cos, rope_sin, q2.dtype)
    return out.reshape(B, G, 2, N, d).transpose(2, 3).reshape(B, G, N, dd).to(q2.dtype)


def attention_fat_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 on flat (B, N, H*64) tensors."""
    B, N, D = q.shape
    H = D // HEAD_DIM

    def heads(t):  # (B, N, H*64) -> (B, H, N, 64)
        return t.reshape(B, N, H, HEAD_DIM).transpose(1, 2)

    nv = N if n_valid is None else n_valid
    out = _attend(heads(q), heads(k), heads(v), scale, nv, rope_cos, rope_sin, q.dtype)
    return out.transpose(1, 2).reshape(B, N, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry ``cbas_<name>`` of ``csrc/<name>.cu``, built at first use.
    All three share one signature: eight pointers (q, k, v, o, the tables,
    the q and k scratch), (B, N, H, head_dim), q's and then o's (batch,
    group, row) element strides, n_valid, scale, dtype, the stream, the
    body it ran and the fp32 body's prologue launches it queued."""
    from cbas_tpu_torch.ops import _cuda

    fn = getattr(_cuda.load(name), f"cbas_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return fn


def _check(q, k, v, N, head_dim, n_valid, rope_cos, rope_sin) -> int:
    """What every layout checks: k and v like q, ``n_valid`` in [1, N], and
    (N, head_dim) tables on q's device. Returns the live key count."""
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}"
            )
    nv = N if n_valid is None else int(n_valid)
    if not 1 <= nv <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin go together")
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if t.shape != (N, head_dim) or t.device != q.device:
                raise ValueError(
                    f"{name} must be ({N}, {head_dim}) on {q.device}, got "
                    f"{tuple(t.shape)} on {t.device}"
                )
    return nv


def _dense_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``t``'s shape, dtype and device, dense, with its
    dims laid out in ``t``'s order (outermost: the largest stride; ties in
    dim order): ``t``'s own strides for a dense ``t``, and for a view of a
    wider buffer the strides it would have without the holes."""
    order = sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))
    out = torch.empty([t.shape[i] for i in order], dtype=t.dtype, device=t.device)
    return out.permute([order.index(i) for i in range(t.dim())])


def _in_dense_order(q: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (q's shape), laid out as :func:`_dense_like` lays out q's
    output: itself if it is so already, else a copy."""
    dense = _dense_like(q)
    return out if out.stride() == dense.stride() else dense.copy_(out)


def _require_contiguous(**tensors) -> None:
    """Contiguous and 16-byte aligned, as every kernel reads its tables and
    K3 what the wrapper copied."""
    for arg, t in tensors.items():
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{arg} must be contiguous and 16-byte aligned")


def _check_strides(names, q, k, v, unit: int = 16, base: int = 16) -> None:
    """What the kernels take besides contiguous tensors: q, k and v (called
    ``names`` in the messages) with one set of strides, the last dim
    contiguous, every other stride (of a dim longer than 1) a multiple of
    ``unit`` bytes and each base address a multiple of ``base`` bytes (the
    tensor maps' rule, at the defaults), and no two elements at one address.
    The output (:func:`_dense_like`) is held to the same rule."""
    if not q.stride() == k.stride() == v.stride():
        raise ValueError(
            f"{names[0]}, {names[1]} and {names[2]} must share strides, got {q.stride()}, "
            f"{k.stride()} and {v.stride()}"
        )
    if q.stride(-1) != 1:
        raise ValueError(f"the last dim must have stride 1, got stride {q.stride(-1)}")
    size = q.element_size()
    extent = q.shape[-1]  # elements spanned so far, innermost first
    for stride, n, dim in sorted((q.stride(i), q.shape[i], i) for i in range(q.dim() - 1)):
        if n == 1:
            continue
        if stride * size % unit:
            raise ValueError(f"stride {stride} of dim {dim} is not a multiple of {unit} bytes")
        if stride < extent:
            raise ValueError(f"stride {stride} of dim {dim} overlaps the elements within it")
        extent += stride * (n - 1)
    for arg, t in zip(names, (q, k, v)):
        if t.data_ptr() % base:
            raise ValueError(f"{arg} starts at {t.data_ptr():#x}, not a {base}-byte multiple")


def _layout(t: torch.Tensor) -> tuple:
    """The (batch, group, row) element strides of a kernel operand: a flat
    (B, N, H*64) tensor is one group of heads (group stride 0), a packed or
    head-major (B, G, N, w) one G groups."""
    if t.dim() == 3:
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def _launch(name, q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, d, width=None) -> torch.Tensor:
    """Launch ``csrc/<name>.cu``'s kernel on a CUDA tensor, or raise. q, k
    and v share q's strides; the output (and the scratch for roped keys and
    queries, where the body needs it) is allocated dense in q's dim order
    (:func:`_dense_like`), and the kernel gets both sets of strides
    (:func:`_layout`). ``d`` is the heads' width and ``width`` the one the
    kernel runs at (K3: a built width >= d, whose extra columns the kernel
    reads as zeros; d by default)."""
    width = d if width is None else width
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    cos = sin = None
    if rope_cos is not None:
        cos = rope_cos.to(torch.float32).contiguous()
        sin = rope_sin.to(torch.float32).contiguous()
    _require_contiguous(rope_cos=cos, rope_sin=sin)
    want = attention_body(name, q.dtype, width)
    body, prologues = ctypes.c_int(-1), ctypes.c_int(0)
    with torch.cuda.device(q.device):
        out = _dense_like(q)
        _check_strides(("out",) * 3, out, out, out, math.gcd(16, d * q.element_size()))
        # Roped keys (the Hopper body), and roped queries too where the
        # kernel cannot rope them itself (the wide body, d below the width it
        # runs at), laid out as the output is: dense, without a fused
        # buffer's holes. Rows that are no 32-byte multiple (bf16 up to 256)
        # are staged instead, with tables or without: q into q_scratch, k
        # and v into two planes of k_scratch, rows of stage_width(d). The
        # fp32 Hopper bodies' prologue writes K and V
        # split (and K roped) into its own scratch, at the width they run
        # at, with tables or without.
        q_scratch = k_scratch = None
        if want in BF16_BODIES and headmajor_staged(q.dtype, d):
            plane = B * H * N * stage_width(d)
            q_scratch = torch.empty(plane, dtype=q.dtype, device=q.device)
            k_scratch = torch.empty(2 * plane, dtype=q.dtype, device=q.device)
        elif cos is not None and want in BF16_BODIES + ("wide",):
            k_scratch = _dense_like(q)
            if want == "wide" or width != d:
                q_scratch = _dense_like(q)
        if want in TF32_BODIES:
            k_scratch = torch.empty(4 * B * H * tf32_scratch_keys(nv) * tf32_width(width),
                                    dtype=torch.float32, device=q.device)
        err = _kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin, q_scratch, k_scratch)),
            B, N, H, d, *_layout(q), *_layout(out), nv, float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream, ctypes.byref(body), ctypes.byref(prologues),
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    ran = _BODIES.get(body.value, f"unknown ({body.value})")
    if ran != want:
        raise RuntimeError(f"{name} ran the {ran} body where attention_body says {want}")
    _count_launch(name, width, ran, prologues.value)
    return out


def _count_launch(name: str, d: int, body: str, prologues: int = 0) -> None:
    """One launch of entry ``name`` at head dim ``d`` through ``body``, and
    the ``prologues`` launches its C entry reported queuing before it (the
    fp32 bodies' prologue, or bf16's staging pass), in the module's
    counters."""
    global launches, launches_packed, launches_headmajor, launches_sm90, launches_wide
    global launches_sm90_f32, launches_sm90_f32_wide, launches_sm90_f32_slices
    global launches_tf32_prologue, launches_stage, launches_sm90_ws
    with _count_lock:
        if name == "attention_fat":
            launches += 1
        elif name == "attention_packed":
            launches_packed += 1
        else:
            launches_headmajor += 1
            launches_headmajor_by_dim[d] = launches_headmajor_by_dim.get(d, 0) + 1
        if body == "sm90":
            launches_sm90 += 1
            launches_sm90_by_kernel[name] = launches_sm90_by_kernel.get(name, 0) + 1
        elif body == "sm90_f32":
            launches_sm90_f32 += 1
            launches_sm90_f32_by_kernel[name] = launches_sm90_f32_by_kernel.get(name, 0) + 1
        elif body == "sm90_f32_wide":
            launches_sm90_f32_wide += 1
        elif body == "sm90_f32_slices":
            launches_sm90_f32_slices += 1
        elif body == "wide":
            launches_wide += 1
        elif body == "sm90_ws":
            launches_sm90_ws += 1
        if body in TF32_BODIES:
            launches_tf32_prologue += prologues
        else:
            launches_stage += prologues


def fused_attention_fat(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1: attention over flat (B, N, H*64) q, k, v; returns (B, N, H*64) in
    q's dtype, dense (contiguous for q's usual dim order).

    q, k and v may be strided views, such as the column blocks
    ``qkv[..., :D]``, ``qkv[..., D:2D]`` and ``qkv[..., 2D:]`` of one fused
    (B, N, 3D) projection: one set of strides for the three, the last dim
    contiguous, the others and the base addresses 16-byte multiples, no
    overlap (raises ``ValueError`` otherwise, on every device).
    ``rope_cos``/``rope_sin`` are full-length (N, 64) tables (identity rows for
    prefix tokens). Keys at or beyond ``n_valid`` are masked.
    """
    if q.dim() != 3:
        raise ValueError(f"expected flat (B, N, H*64) tensors, got q of shape {tuple(q.shape)}")
    B, N, D = q.shape
    if D % HEAD_DIM:
        raise ValueError(f"last dim {D} is not a multiple of the head dim {HEAD_DIM}")
    nv = _check(q, k, v, N, HEAD_DIM, n_valid, rope_cos, rope_sin)
    _check_strides(("q", "k", "v"), q, k, v)
    if q.device.type == "cpu":
        return _in_dense_order(q, attention_fat_reference(q, k, v, scale, nv, rope_cos, rope_sin))
    return _launch("attention_fat", q, k, v, scale, nv, rope_cos, rope_sin, B, N, D // HEAD_DIM,
                   HEAD_DIM)


def fused_attention_packed(
    q2: torch.Tensor,
    k2: torch.Tensor,
    v2: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2: attention over head-pair packed (B, G, N, 128) tensors, two 64-wide
    heads side by side on the last dim; returns the same packed layout,
    dense in q2's dim order.

    q2, k2 and v2 may be strided views, such as
    ``t.view(B, N, G, 128).transpose(1, 2)`` of a flat (B, N, G*128) column
    block of a fused projection, whose output is then
    ``empty(B, N, G, 128).transpose(1, 2)``: one set of strides for the
    three, the last dim contiguous,
    the others and the base addresses 16-byte multiples, no overlap (raises
    ``ValueError`` otherwise, on every device).
    ``rope_cos``/``rope_sin`` are (N, 64): both heads of a pair share them.
    """
    if q2.dim() != 4 or q2.shape[-1] != 2 * HEAD_DIM:
        raise ValueError(
            f"expected packed (B, H/2, N, {2 * HEAD_DIM}) tensors (two {HEAD_DIM}-wide heads "
            f"a row), got q2 of shape {tuple(q2.shape)}"
        )
    B, G, N, _ = q2.shape
    nv = _check(q2, k2, v2, N, HEAD_DIM, n_valid, rope_cos, rope_sin)
    _check_strides(("q2", "k2", "v2"), q2, k2, v2)
    if q2.device.type == "cpu":
        return _in_dense_order(q2, attention_packed_reference(q2, k2, v2, scale, nv, rope_cos,
                                                              rope_sin))
    return _launch("attention_packed", q2, k2, v2, scale, nv, rope_cos, rope_sin, B, N, 2 * G,
                   HEAD_DIM)


@functools.lru_cache(maxsize=None)
def _prologue_kernel():
    """``cbas_attention_tf32_prologue`` of ``csrc/attention_headmajor.cu``:
    the fp32 Hopper bodies' prologue alone."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_headmajor").cbas_attention_tf32_prologue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    return fn


def tf32_prologue(
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fp32 Hopper bodies' prologue alone on head-major (B, H, N, d) fp32
    k and v (d a multiple of 4 up to 256, or any d above; any strides the
    kernels take; tables need an even d): the (4, B, H, n_keys,
    :func:`tf32_width` (d)) scratch that K1-K3's fp32 launches write before
    their attention kernel. On a CPU tensor, :func:`tf32_prologue_reference`;
    on a CUDA one, the kernel (``csrc/attention_sm90_tf32.cuh``'s split_kv,
    above 256 ``attention_sm90_tf32_slices.cuh``'s split_kv_wide), the same
    bits, or raise."""
    if k.dim() != 4 or k.dtype != torch.float32 or (k.shape[-1] % 4 and k.shape[-1] <= 256):
        raise ValueError(f"expected head-major fp32 (B, H, N, d) k, d a multiple of 4 up to "
                         f"256 or any d above, got {tuple(k.shape)} {k.dtype}")
    B, H, N, d = k.shape
    width = tf32_width(d)
    nv = _check(k, k, v, N, d, n_valid, rope_cos, rope_sin)
    if rope_cos is not None and d % 2:
        raise ValueError(f"RoPE tables need an even head dim, got {d}")
    _check_strides(("k", "k", "v"), k, k, v, math.gcd(16, d * k.element_size()))
    if k.device.type == "cpu":
        return tf32_prologue_reference(k, v, nv, rope_cos, rope_sin, width)
    if k.device.type != "cuda":
        raise ValueError(f"tf32_prologue runs on cpu or cuda, not {k.device}")
    cos = sin = None
    if rope_cos is not None:
        cos, sin = (t.to(torch.float32).contiguous() for t in (rope_cos, rope_sin))
    _require_contiguous(rope_cos=cos, rope_sin=sin)
    with torch.cuda.device(k.device):
        out = torch.empty(4, B, H, tf32_scratch_keys(nv), width, dtype=torch.float32,
                          device=k.device)
        err = _prologue_kernel()(
            k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin)),
            B, N, H, d, k.stride(0), k.stride(1), k.stride(2), nv,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"tf32_prologue kernel launch failed with CUDA error {err}")
    global launches_tf32_prologue
    with _count_lock:
        launches_tf32_prologue += 1
    return out


def padded_head_dim(d: int) -> int:
    """The width an fp32 head of width d that K3 copies first is padded to:
    up to 256, d rounded up to a multiple of 4 (the fp32 Hopper bodies read
    that in place); above 256, d itself (the slices body takes any d)."""
    return d if d > 256 else -(-d // 4) * 4


def headmajor_in_place(dtype: torch.dtype, d: int, rope: bool = False) -> bool:
    """Whether K3 reads a d-wide head where it lies on the card (no pad
    copy, no RoPE outside a kernel): in bf16 at every d; in fp32 at every
    multiple of 4 and above 256, but never at an odd d with RoPE tables."""
    if dtype == torch.bfloat16:
        return True
    if rope and d % 2:
        return False
    return d > 256 or d % 4 == 0


def headmajor_staged(dtype: torch.dtype, d: int, rope: bool = False) -> bool:
    """Whether a K3 call on the card launches bf16's staging pass before its
    attention kernel (``launches_stage``): up to 192 at a d whose rows are no
    32-byte multiple (d % 16 != 0), from 193 to 256 at one whose rows are no
    16-byte multiple (d % 8 != 0), above 256 at an odd d with RoPE tables."""
    if dtype != torch.bfloat16:
        return False
    if d > 256:
        return rope and d % 2 == 1
    return bool(d % (STAGE_ROW_UNIT if d <= 192 else WS_ROW_UNIT))


def stage_width(d: int) -> int:
    """The elements a row of bf16's staging scratch holds: d rounded up to
    STAGE_ROW_UNIT."""
    return -(-d // STAGE_ROW_UNIT) * STAGE_ROW_UNIT


def headmajor_width(dtype: torch.dtype, d: int) -> int:
    """The width K3's kernel runs a d-wide head at (the key of
    ``launches_headmajor_by_dim``): up to 256 the next of BF16_HEAD_DIMS in
    bf16, of HEADMAJOR_HEAD_DIMS in fp32 (:func:`tf32_width`; fp32 pads a
    width that is no multiple of 4 below it first), d itself above."""
    if d > 256:
        return d
    if dtype == torch.bfloat16:
        return next(w for w in BF16_HEAD_DIMS if w >= d)
    return tf32_width(d)


def pad_head_dim(t: torch.Tensor, width: int, halves: bool) -> torch.Tensor:
    """``t`` with its last dim zero-padded from d to ``width``, contiguous, in
    one copy.

    With ``halves`` (RoPE), each half of d is padded on its own, to half of
    ``width``: rotate-half pairs element i with i + d/2, so padding at the
    end would pair elements that RoPE does not. A zero element stays zero
    under any table, so the scores and the output's first d elements are
    those of the d-wide head."""
    d = t.shape[-1]
    if not halves:
        return torch.nn.functional.pad(t, (0, width - d))
    halves_of_t = t.unflatten(-1, (2, d // 2))
    return torch.nn.functional.pad(halves_of_t, (0, (width - d) // 2)).flatten(-2)


def unpad_head_dim(t: torch.Tensor, d: int, halves: bool) -> torch.Tensor:
    """The inverse of :func:`pad_head_dim`: the d elements it placed, in one
    copy."""
    if not halves:
        return t[..., :d].contiguous()
    return t.unflatten(-1, (2, t.shape[-1] // 2))[..., : d // 2].flatten(-2)


def _rope_heads(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                scale: float = 1.0) -> torch.Tensor:
    """RoPE on head-major ``t`` in fp32, times ``scale``, rounded once to
    ``t``'s dtype: the values the plain version rounds to at the same point
    (q with the scale folded in, k without)."""
    x = t.float()
    return ((x * cos.float() + rotate_half(x) * sin.float()) * scale).to(t.dtype)


def bf16_stage_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K3's bf16 staging pass on head-major (B, H,
    N, d) q, k and v: a (3, B, H, N, width) tensor in q's dtype (``width``
    >= d, by default :func:`stage_width`), its planes q roped
    with the (N, d) tables (rotate-half at any d, :func:`rotate_half`) and
    times ``scale``, k roped, v as it is, each rounded once from fp32 as
    :func:`attention_headmajor_reference` rounds them; rows of k and v at
    or beyond ``n_valid`` and the columns from d on are zeros. Without
    tables k and v pass bit for bit. The kernel writes the same bits."""
    B, H, N, d = q.shape
    w = stage_width(d) if width is None else width
    nv = N if n_valid is None else n_valid
    out = torch.zeros(3, B, H, N, w, dtype=q.dtype, device=q.device)
    qh, kh = q.float(), k[:, :, :nv].float()
    if rope_cos is not None:
        cos, sin = rope_cos.float(), rope_sin.float()
        qh = qh * cos + rotate_half(qh) * sin
        kh = kh * cos[:nv] + rotate_half(kh) * sin[:nv]
    out[0, ..., :d] = (qh * scale).to(q.dtype)
    out[1, :, :, :nv, :d] = kh.to(q.dtype) if rope_cos is not None else k[:, :, :nv]
    out[2, :, :, :nv, :d] = v[:, :, :nv]
    return out


@functools.lru_cache(maxsize=None)
def _stage_kernel():
    """``cbas_attention_bf16_stage`` of ``csrc/attention_headmajor.cu``: the
    staging pass alone."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_headmajor").cbas_attention_bf16_stage
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return fn


def bf16_stage(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3's bf16 staging pass alone on head-major (B, H, N, d) bf16 q, k and
    v (one set of strides, the last dim contiguous, any alignment): the
    (3, B, H, N, :func:`stage_width` (d)) tensor that K3 stages into
    before its attention kernel where :func:`headmajor_staged` says so
    (there laid out in q's dim order). On a CPU tensor, :func:`bf16_stage_reference`; on a CUDA one,
    the kernel (``csrc/attention_common.cuh``'s stage_rows), the same bits,
    or raise."""
    if q.dim() != 4 or q.dtype != torch.bfloat16:
        raise ValueError(f"expected head-major bf16 (B, H, N, d) q, got {tuple(q.shape)} {q.dtype}")
    B, H, N, d = q.shape
    nv = _check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    _check_strides(("q", "k", "v"), q, k, v, math.gcd(16, 2 * d), 2)
    if q.device.type == "cpu":
        return bf16_stage_reference(q, k, v, scale, nv, rope_cos, rope_sin)
    if q.device.type != "cuda":
        raise ValueError(f"bf16_stage runs on cpu or cuda, not {q.device}")
    cos = sin = None
    if rope_cos is not None:
        cos, sin = (t.to(torch.float32).contiguous() for t in (rope_cos, rope_sin))
    _require_contiguous(rope_cos=cos, rope_sin=sin)
    with torch.cuda.device(q.device):
        out = torch.empty(3, B, H, N, stage_width(d), dtype=q.dtype, device=q.device)
        out[1:, :, :, nv:] = 0  # rows the pass does not write
        err = _stage_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin)),
            B, N, H, d, q.stride(0), q.stride(1), q.stride(2), nv, float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"bf16_stage kernel launch failed with CUDA error {err}")
    global launches_stage
    with _count_lock:
        launches_stage += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3: attention over head-major (B, H, N, d) tensors; returns (B, H, N, d)
    in q's dtype.

    ``rope_cos``/``rope_sin`` are full-length (N, d) tables. On a CPU tensor
    the plain version runs. On the card the kernel reads q, k and v where
    they lie, and writes the output dense in q's dim order, at every d but
    one case below (:func:`headmajor_in_place`): up to 256 at the next of
    BF16_HEAD_DIMS (fp32: HEADMAJOR_HEAD_DIMS) with its tensor maps at d,
    so the columns beyond d read as zeros and no copy pads the head (bf16
    rows that the body does not read in place, :func:`headmajor_staged`, go
    through one staging launch into scratch first, RoPE with it at any d);
    above 256 at d (the wide body in bf16,
    the fp32 slices body in fp32). There q, k and v may be strided views,
    such as ``t.view(B, N, H, d).transpose(1, 2)`` of a flat (B, N, H*d)
    column block of a fused projection, whose output is then
    ``empty(B, N, H, d).transpose(1, 2)`` and its ``transpose(1,
    2).reshape(B, N, H*d)`` a view: one set of strides for the three, the
    last dim contiguous, the other strides multiples of 16 bytes (of the
    largest power of two up to 16 that divides a row's bytes, for rows that
    are not 16-byte multiples), base addresses multiples of 16 bytes (in
    bf16, of that power of two), no overlap (raises ``ValueError``
    otherwise, on every device).

    fp32 at a width up to 256 that is no multiple of 4 still copies first,
    takes any strides and returns a contiguous tensor: q, k and v (and the
    tables, half by half, with RoPE) zero-padded to the next multiple of 4
    (:func:`pad_head_dim`), the output sliced back, ``scale`` unchanged; at
    an odd d with tables, q and k roped here first (:func:`_rope_heads`, the
    scale folded into q) and the kernel run without tables at scale 1:
    rotate-half pairs element i of an odd head with element i + d // 2 for
    i <= d // 2 and with i - d // 2 - 1 above, a pairing no zero pad keeps.
    The same holds above 256 at an odd d with tables (roped here, no pad).
    """
    if q.dim() != 4:
        raise ValueError(f"expected head-major (B, H, N, d) tensors, got q of shape {tuple(q.shape)}")
    B, H, N, d = q.shape
    nv = _check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    in_place = headmajor_in_place(q.dtype, d, rope_cos is not None)
    if in_place:
        unit = math.gcd(16, d * q.element_size())
        _check_strides(("q", "k", "v"), q, k, v, unit, unit if q.dtype == torch.bfloat16 else 16)
    if q.device.type == "cpu":
        out = attention_headmajor_reference(q, k, v, scale, nv, rope_cos, rope_sin)
        return _in_dense_order(q, out) if in_place else out
    if in_place:
        return _launch("attention_headmajor", q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, d,
                       headmajor_width(q.dtype, d))
    width = padded_head_dim(d)
    if rope_cos is not None and d % 2 == 1:
        q = _rope_heads(q, rope_cos, rope_sin, scale)
        k = _rope_heads(k, rope_cos, rope_sin)
        scale, rope_cos, rope_sin = 1.0, None, None
    halves = rope_cos is not None
    if width != d:
        q, k, v = (pad_head_dim(t, width, halves) for t in (q, k, v))
        if halves:
            rope_cos, rope_sin = (pad_head_dim(t, width, True) for t in (rope_cos, rope_sin))
    q, k, v = (t.contiguous() for t in (q, k, v))
    _require_contiguous(q=q, k=k, v=v)
    out = _launch("attention_headmajor", q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, width,
                  headmajor_width(q.dtype, width))
    return out if width == d else unpad_head_dim(out, d, halves)


def reference_attention(q, k, v, scale):
    """The unfused head-major (B, H, N, d) path (fp32 softmax)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
