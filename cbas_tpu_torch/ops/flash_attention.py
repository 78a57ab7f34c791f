"""Fused attention in the three layouts of the JAX package.

Port of ``cbas_tpu/ops/flash_attention.py``'s three Pallas entries, with
their names and argument order (the TPU-only ``block_q``, ``interpret`` and
``pvt`` arguments dropped):

- :func:`fused_attention_fat` (K1): flat (B, N, H*64), straight out of the
  2-D projection matmuls and into the out-projection, so no transpose
  surrounds the call.
- :func:`fused_attention_packed` (K2): head-pair packed (B, H/2, N, 128),
  two 64-wide heads side by side on the last dim. It takes strided views
  (such as ``t.view(B, N, H // 2, 128).transpose(1, 2)`` of a flat
  projection) as well as contiguous tensors, and returns q2's strides.
- :func:`fused_attention` (K3): head-major (B, H, N, d), any d on the
  card: the kernel is built at every multiple of 8 up to 128, and at 192
  and 256, a head of another width up to 256 runs zero-padded to the next
  of those (:func:`pad_head_dim`), and a wider head runs the wide body,
  which takes d at run time. An odd d with RoPE tables is roped here and
  launched without them (rotate-half's pairing of an odd d survives no pad).

All three compute one function per head: optional rotate-half RoPE from fp32
(N, d) tables, the scale on the q side, keys at or beyond ``n_valid`` masked,
exact fp32 softmax, output in q's dtype.

- On a CUDA tensor each wrapper launches its hand-written kernel
  (``csrc/attention_{fat,packed,headmajor}.cu``) or raises. None falls back.
- On a CPU tensor it runs its plain PyTorch version
  (``attention_{fat,packed,headmajor}_reference``).

Two bodies serve the three entries (:func:`attention_body`): bfloat16 at
head dims 64 and 128 takes the Hopper body (``csrc/attention_sm90.cuh``: TMA
ring, wgmma, RoPE once per token and head, tensor maps built from the
tensors' strides); float32 and K3's other head dims take
``csrc/attention_common.cuh``'s.

``launches`` (K1), ``launches_packed`` (K2) and ``launches_headmajor`` (K3)
count kernel launches and nothing else, so a run can show which kernels its
main path went through; ``launches_headmajor_by_dim`` splits K3's by the
head dim the kernel ran at (the padded width), and ``launches_sm90`` counts
those of them all that ran the Hopper body, as the C entry reports it
(``launches_sm90_by_kernel`` by entry). The shards of a device mesh launch
from threads of their own, so every count is updated under one lock.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional

import torch

HEAD_DIM = 64       # K1's and K2's head width
# K3's built head dims: every multiple of 8 up to 128 (no public DINO
# checkpoint is wider), and 192 and 256; each instantiated width adds to the
# kernel's build, so other widths up to 256 run zero-padded to the next one.
HEADMAJOR_HEAD_DIMS = tuple(range(8, 129, 8)) + (192, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0            # K1, fused_attention_fat
launches_packed = 0     # K2, fused_attention_packed
launches_headmajor = 0  # K3, fused_attention
launches_headmajor_by_dim: dict = {}  # K3's launches by head dim
launches_sm90 = 0       # launches of any entry that ran the Hopper body
launches_sm90_by_kernel: dict = {}  # the same, by entry ("attention_fat", ...)
_count_lock = threading.Lock()  # shard threads launch concurrently

_SM90_HEAD_DIMS = {"attention_fat": (64,), "attention_packed": (64,),
                   "attention_headmajor": (64, 128)}


def attention_body(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The body entry ``kernel`` (``attention_fat``, ``attention_packed`` or
    ``attention_headmajor``) runs for ``dtype`` and ``head_dim``: "sm90" (the
    Hopper body, bfloat16 at the head dims it is built for) or "common". The
    C entries route by the same rule and report the body they ran."""
    if dtype == torch.bfloat16 and head_dim in _SM90_HEAD_DIMS.get(kernel, ()):
        return "sm90"
    return "common"


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
    All three share one signature: seven pointers, (B, N, H, head_dim), the
    (batch, group, row) element strides, n_valid, scale, dtype, the stream
    and the body it ran."""
    from cbas_tpu_torch.ops import _cuda

    fn = getattr(_cuda.load(name), f"cbas_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
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


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor with ``t``'s shape, dtype, device and strides
    (``torch.empty_like`` keeps the strides of a dense ``t`` only)."""
    out = torch.empty_like(t)
    if out.stride() == t.stride():
        return out
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device)


def _require_contiguous(**tensors) -> None:
    """K1's and K3's kernels read contiguous rows in 16-byte chunks."""
    for arg, t in tensors.items():
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{arg} must be contiguous and 16-byte aligned")


def _check_packed_strides(q2, k2, v2) -> None:
    """What K2 takes besides contiguous tensors: q2, k2 and v2 with one set
    of strides, the last dim contiguous, every other stride (of a dim longer
    than 1) and each base address a 16-byte multiple (the tensor maps' rule),
    and no two elements at one address (the output takes these strides)."""
    if not q2.stride() == k2.stride() == v2.stride():
        raise ValueError(
            f"q2, k2 and v2 must share strides, got {q2.stride()}, {k2.stride()} and "
            f"{v2.stride()}"
        )
    if q2.stride(-1) != 1:
        raise ValueError(f"the last dim must have stride 1, got stride {q2.stride(-1)}")
    size = q2.element_size()
    extent = q2.shape[-1]  # elements spanned so far, innermost first
    for stride, n, dim in sorted((q2.stride(i), q2.shape[i], i) for i in range(3)):
        if n == 1:
            continue
        if stride * size % 16:
            raise ValueError(f"stride {stride} of dim {dim} is not a multiple of 16 bytes")
        if stride < extent:
            raise ValueError(f"stride {stride} of dim {dim} overlaps the elements within it")
        extent += stride * (n - 1)
    for arg, t in (("q2", q2), ("k2", k2), ("v2", v2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{arg} starts at {t.data_ptr():#x}, not a 16-byte multiple")


def _launch(name, q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, d, strides) -> torch.Tensor:
    """Launch ``csrc/<name>.cu``'s kernel on a CUDA tensor, or raise.
    ``strides`` are q's (batch, group, row) element strides, which k and v
    share; the output (and, for the Hopper body with tables, a scratch
    buffer for the roped keys) is allocated with them."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    cos = sin = None
    if rope_cos is not None:
        cos = rope_cos.to(torch.float32).contiguous()
        sin = rope_sin.to(torch.float32).contiguous()
    _require_contiguous(rope_cos=cos, rope_sin=sin)
    want = attention_body(name, q.dtype, d)
    body = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        out = _like(q)
        scratch = _like(k) if want == "sm90" and cos is not None else None
        err = _kernel(name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            B, N, H, d, *strides, nv, float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream, ctypes.byref(body),
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    ran = "sm90" if body.value == 1 else "common"
    if ran != want:
        raise RuntimeError(f"{name} ran the {ran} body where attention_body says {want}")
    _count_launch(name, d, ran)
    return out


def _count_launch(name: str, d: int, body: str) -> None:
    """One launch of entry ``name`` at head dim ``d`` through ``body``, in
    the module's counters."""
    global launches, launches_packed, launches_headmajor, launches_sm90
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
    q's dtype.

    ``rope_cos``/``rope_sin`` are full-length (N, 64) tables (identity rows for
    prefix tokens). Keys at or beyond ``n_valid`` are masked.
    """
    if q.dim() != 3:
        raise ValueError(f"expected flat (B, N, H*64) tensors, got q of shape {tuple(q.shape)}")
    B, N, D = q.shape
    if D % HEAD_DIM:
        raise ValueError(f"last dim {D} is not a multiple of the head dim {HEAD_DIM}")
    nv = _check(q, k, v, N, HEAD_DIM, n_valid, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return attention_fat_reference(q, k, v, scale, nv, rope_cos, rope_sin)
    _require_contiguous(q=q, k=k, v=v)
    return _launch("attention_fat", q, k, v, scale, nv, rope_cos, rope_sin, B, N, D // HEAD_DIM,
                   HEAD_DIM, (N * D, 0, D))


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
    heads side by side on the last dim; returns the same packed layout, with
    q2's strides.

    q2, k2 and v2 may be strided views, such as
    ``t.view(B, N, G, 128).transpose(1, 2)`` of a flat (B, N, G*128)
    projection: one set of strides for the three, the last dim contiguous,
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
    _check_packed_strides(q2, k2, v2)
    if q2.device.type == "cpu":
        return _like(q2).copy_(attention_packed_reference(q2, k2, v2, scale, nv, rope_cos,
                                                          rope_sin))
    return _launch("attention_packed", q2, k2, v2, scale, nv, rope_cos, rope_sin, B, N, 2 * G,
                   HEAD_DIM, (q2.stride(0), q2.stride(1), q2.stride(2)))


def padded_head_dim(d: int) -> int:
    """The width K3 runs a d-wide head at: the smallest built head dim that
    is at least d, or d itself above 256 (the wide body takes any d)."""
    for width in HEADMAJOR_HEAD_DIMS:
        if width >= d:
            return width
    return d


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
    the plain version runs. On the card any d runs: a width up to 256 that
    the kernel is not built at runs zero-padded to the next built one
    (:func:`padded_head_dim`) and is sliced back, ``scale`` unchanged; a
    width above 256 runs the wide body at d. With tables and an odd d, q and
    k are roped here (:func:`_rope_heads`, the scale folded into q) and the
    kernel runs without tables at scale 1: rotate-half pairs element i of an
    odd head with element i + d // 2 for i <= d // 2 and with i - d // 2 - 1
    above, a pairing no zero pad keeps.
    """
    if q.dim() != 4:
        raise ValueError(f"expected head-major (B, H, N, d) tensors, got q of shape {tuple(q.shape)}")
    B, H, N, d = q.shape
    nv = _check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    if q.device.type == "cpu":
        return attention_headmajor_reference(q, k, v, scale, nv, rope_cos, rope_sin)
    if rope_cos is not None and d % 2:
        q = _rope_heads(q, rope_cos, rope_sin, scale)
        k = _rope_heads(k, rope_cos, rope_sin)
        scale, rope_cos, rope_sin = 1.0, None, None
    width = padded_head_dim(d)
    halves = rope_cos is not None
    if width != d:
        q, k, v = (pad_head_dim(t, width, halves) for t in (q, k, v))
        if halves:
            rope_cos, rope_sin = (pad_head_dim(t, width, True) for t in (rope_cos, rope_sin))
    _require_contiguous(q=q, k=k, v=v)
    out = _launch("attention_headmajor", q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, width,
                  (H * N * width, N * width, width))
    return out if width == d else unpad_head_dim(out, d, halves)


def reference_attention(q, k, v, scale):
    """The unfused head-major (B, H, N, d) path (fp32 softmax)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
