"""Stage variants of the Hopper attention body, for timing K1-K3's inner loop.

Port of two TPU probes of ``benchmarks/attn_probes/``, which time the packed
kernel's stages one at a time at its 640x480 shape:

- ``probe2.py`` (``make_variant``'s ``pallas_call``): ``dma_kernel``
  (``"dma"``), ``qk_kernel`` (``"qk"``), ``nosm_kernel`` (``"nosm"``) and
  ``pipe_kernel`` (``"pipe"``);
- ``probe4.py`` (``make_variant``): ``vext_kernel`` with ``bf16exp`` off
  (``"vext"``) and on (``"vext_bf16exp"``).

On the card each is a compile-time variant of the one-warpgroup Hopper body
(``csrc/attention_sm90.cuh``, enum ``Variant``; the C entry
``csrc/attention_variants.cu``): the producer warp, the TMA ring, the tensor
maps and the store are the same, and each variant drops or changes one stage
of the consumer, so the difference of two variants' times is one stage's
cost. They time the one-warpgroup body's loop, the one K1-K3 run (variant 0
is that body itself), and not the persistent body's
(``csrc/attention_sm90_persistent.cuh``, a timing case of its own). No
encode route calls them; ``chip_smoke.py``'s stage phase times them beside
variant 0.

The functions, on each head of q, k and v (rounding points in
:func:`attention_variant_reference`):

- ``dma``: o = q, bit for bit (no RoPE, no arithmetic).
- ``qk``: o[i, c] = bf16(s[i, c]) for c < d: the scores of keys 0 .. d-1,
  s = (roped, scaled q) . (roped k)^T with k's rows at or past ``n_valid``
  read as zeros (the kernel's tensor maps end at ``n_valid``). The probe
  masks nothing and reads every row; at ``n_valid = N`` the two agree.
- ``nosm``: o = bf16(bf16(s) . V), V's rows at or past ``n_valid`` zero: no
  mask, max, exponential or row sum (the probe's, at ``n_valid = N``).
- ``pipe``: the full function, as K1-K3 compute it, in FA3's order (the
  next key tile's q.k^T and this tile's p.V in flight under the next tile's
  softmax), on a ring and register budget of its own
  (:func:`launch_config`); bit for bit variant 0. It ran 1.18-1.68x
  variant 0's time at the main shapes (``PERF.md`` §6), so no route takes
  it.
- ``vext``: the full function with the row sums taken from the p.V product:
  o = (bf16(p) . V) / (bf16(p) . 1), fp32 sums, over 64-key tiles against a
  running max as the kernel takes them.
- ``vext_bf16exp``: the same with the exponential in bf16:
  p = bf16(2^bf16(x)), x = s log2(e) - max log2(e) in fp32.

:func:`attention_variant` takes q, k and v in one of three layouts, as the
kernels do: ``"fat"`` (flat (B, N, H*64), K1's), ``"packed"`` ((B, H/2, N,
128), K2's, the probes' own) or ``"headmajor"`` ((B, H, N, d), d 64 or 128,
K3's); strided views under the kernels' stride rule; bf16 only. The output is
dense in q's dim order.

- On a CUDA tensor it launches the variant's kernel or raises; it does not
  fall back.
- On a CPU tensor it runs the plain version, which the tests hold against
  the probes' kernels.

``launches`` counts kernel launches and nothing else (``launches_by_variant``
by variant), under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from cbas_tpu_torch.ops import flash_attention as fa

VARIANTS = ("dma", "qk", "nosm", "pipe", "vext", "vext_bf16exp")
_VARIANT_CODES = {name: code for code, name in enumerate(VARIANTS, start=1)}  # enum Variant
LAYOUTS = ("fat", "packed", "headmajor")
HEAD_DIMS = {"fat": (64,), "packed": (64,), "headmajor": (64, 128)}
LOG2E = 1.4426950408889634
KEY_TILE = 64  # keys a tile of the kernel's loop (attention_sm90.cuh's kBlockN)

launches = 0
launches_by_variant: dict = {}
_count_lock = threading.Lock()


def _shape(q: torch.Tensor, layout: str) -> tuple:
    """(B, N, H, d) of q in ``layout``; raises on a shape the layout does
    not have."""
    if layout == "fat":
        if q.dim() != 3 or q.shape[-1] % fa.HEAD_DIM:
            raise ValueError(f"expected flat (B, N, H*64) tensors, got q of shape {tuple(q.shape)}")
        B, N, D = q.shape
        return B, N, D // fa.HEAD_DIM, fa.HEAD_DIM
    if layout == "packed":
        if q.dim() != 4 or q.shape[-1] != 2 * fa.HEAD_DIM:
            raise ValueError(f"expected packed (B, H/2, N, 128) tensors, got q of shape "
                             f"{tuple(q.shape)}")
        B, G, N, _ = q.shape
        return B, N, 2 * G, fa.HEAD_DIM
    if layout == "headmajor":
        if q.dim() != 4:
            raise ValueError(f"expected head-major (B, H, N, d) tensors, got q of shape "
                             f"{tuple(q.shape)}")
        B, H, N, d = q.shape
        return B, N, H, d
    raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")


def to_heads(t: torch.Tensor, layout: str) -> torch.Tensor:
    """``t`` in ``layout`` as head-major (B, H, N, d) (a view where one is)."""
    if layout == "fat":
        B, N, D = t.shape
        return t.reshape(B, N, D // fa.HEAD_DIM, fa.HEAD_DIM).transpose(1, 2)
    if layout == "packed":
        B, G, N, dd = t.shape
        return t.reshape(B, G, N, 2, dd // 2).transpose(2, 3).reshape(B, 2 * G, N, dd // 2)
    return t


def from_heads(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Head-major (B, H, N, d) ``t`` in ``layout``: the inverse of
    :func:`to_heads`."""
    B, H, N, d = t.shape
    if layout == "fat":
        return t.transpose(1, 2).reshape(B, N, H * d)
    if layout == "packed":
        return t.reshape(B, H // 2, 2, N, d).transpose(2, 3).reshape(B, H // 2, N, 2 * d)
    return t


def roped_scores(q, k, v, scale, nv, rope_cos, rope_sin, dtype) -> tuple:
    """The first steps of ``flash_attention._attend`` on head-major tensors:
    (q, k, v, s) in fp32, q roped, scaled and rounded to ``dtype``, k roped
    and rounded, k's and v's rows at or past ``nv`` zero, s = q . k^T."""
    N = q.shape[2]
    qh, kh, vh = q.float(), k.float(), v.float()
    if rope_cos is not None:
        cos, sin = rope_cos.float(), rope_sin.float()
        qh = qh * cos + fa.rotate_half(qh) * sin
        kh = kh * cos + fa.rotate_half(kh) * sin
    qh = (qh * scale).to(dtype).float()
    kh = kh.to(dtype).float()
    live = torch.arange(N, device=q.device) < nv
    kh = torch.where(live[:, None], kh, 0.0)  # dead rows' NaN/Inf bits cannot leak
    vh = torch.where(live[:, None], vh, 0.0)
    return qh, kh, vh, qh @ kh.transpose(-1, -2)


def _variant_heads(variant, q, k, v, scale, nv, rope_cos, rope_sin, dtype) -> torch.Tensor:
    """The function of ``variant`` (not "dma") on head-major tensors, in
    fp32; values rounded to ``dtype`` where the kernel rounds them."""
    if variant == "pipe":
        return fa._attend(q, k, v, scale, nv, rope_cos, rope_sin, dtype)
    _, _, vh, s = roped_scores(q, k, v, scale, nv, rope_cos, rope_sin, dtype)
    N, d = s.shape[-1], q.shape[-1]
    if variant == "qk":  # keys 0 .. d-1; keys past N (N < d) are zero rows
        return torch.nn.functional.pad(s[..., :d], (0, max(0, d - N)))
    if variant == "nosm":
        return s.to(dtype).float() @ vh
    return online_softmax(s, vh, nv, bf16exp=variant == "vext_bf16exp")[0]


def online_softmax(s: torch.Tensor, vh: torch.Tensor, nv: int, *, bf16exp: bool) -> tuple:
    """The row-sum variants' loop, as the kernel runs it, over fp32 scores
    ``s`` (.., N, N) and values ``vh`` (.., N, d), keys at or past ``nv``
    left out: tiles of KEY_TILE keys in order, a running max m a row, and per
    tile

    - alpha = 2^((m_old - m) log2(e)) in fp32 (0 on the first tile);
    - x = s log2(e) - (m log2(e)), the product m log2(e) rounded to fp32,
      then x rounded once to fp32 (the kernel's fused multiply-add);
    - p = bf16(2^x) ("vext"), or with ``bf16exp`` p = 2^bf16(x), correctly
      rounded to bf16 (:func:`ex2_bf16`);
    - acc = acc alpha + p . V and lsum = lsum alpha + p . 1, in fp32.

    Returns (o, x, p, a): o = acc (1 / lsum) in fp32 (.., N, d); each key's
    x and p (as fp32; x -inf and p 0 past ``nv``); and its factor a, the
    product of the later tiles' alphas over the final lsum, so that o is
    (p a) . V up to fp32 rounding and the weights p a sum to 1."""
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    m = s.new_full(s.shape[:-1] + (1,), -math.inf)
    acc = s.new_zeros(s.shape[:-1] + (vh.shape[-1],))
    lsum = s.new_zeros(s.shape[:-1] + (1,))
    x = torch.full_like(s, -math.inf)
    p = torch.zeros_like(s)
    alphas = []
    for k0 in range(0, nv, KEY_TILE):
        k1 = min(k0 + KEY_TILE, nv)
        mx = torch.maximum(m, s[..., k0:k1].amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * log2e)
        xt = (s[..., k0:k1].double() * float(log2e) - (mx * log2e).double()).float()
        pt = ex2_bf16(xt.to(torch.bfloat16)) if bf16exp else torch.exp2(xt).to(
            torch.bfloat16).float()
        acc = acc * alpha + pt @ vh[..., k0:k1, :]
        lsum = lsum * alpha + pt.sum(-1, keepdim=True)
        x[..., k0:k1], p[..., k0:k1], m = xt, pt, mx
        alphas.append(alpha)
    a = torch.zeros_like(s)
    later = 1.0 / lsum
    for t in range(len(alphas) - 1, -1, -1):
        a[..., t * KEY_TILE:min((t + 1) * KEY_TILE, nv)] = later
        later = later * alphas[t]
    return acc * (1.0 / lsum), x, p, a


@functools.lru_cache(maxsize=None)
def _ex2_table(device: str) -> torch.Tensor:
    """2^y correctly rounded to bf16 (as fp32), for every bf16 bit pattern y
    in order; flushed as the instruction flushes: y below 2^-126 in size
    reads as 0, and a result below 2^-126 is 0."""
    y = bf16_values("cpu").double()
    y = torch.where(y.abs() < 2.0 ** -126, 0.0, y)
    mant, exp = torch.frexp(torch.exp2(y))
    out = torch.ldexp(torch.round(mant * 256.0) / 256.0, exp)  # round half to even at 8 bits
    out = torch.where(out < 2.0 ** -126, 0.0, out).float()
    return out.to(device)


def bf16_values(device) -> torch.Tensor:
    """Every bf16 value, indexed by its bit pattern as an unsigned 16-bit
    number (:func:`bf16_bits`)."""
    signed = torch.arange(-2 ** 15, 2 ** 15, device=device).to(torch.int16)
    return signed.view(torch.bfloat16).roll(2 ** 15)


def ex2_bf16(y: torch.Tensor) -> torch.Tensor:
    """2^y for bf16 ``y``, correctly rounded to bf16, as fp32: the function
    ``ex2.approx.ftz.bf16x2`` approximates (the card's own results:
    :func:`ex2_bf16_on_card`)."""
    return _ex2_table(str(y.device))[bf16_bits(y)]


def bf16_bits(y: torch.Tensor) -> torch.Tensor:
    """The bit patterns of bf16 ``y`` as int64 in [0, 65536): indices into
    :func:`ex2_bf16`'s table and :func:`ex2_bf16_on_card`'s."""
    return y.view(torch.int16).long() & 0xFFFF


def ex2_bf16_on_card(device) -> torch.Tensor:
    """What ``ex2.approx.ftz.bf16x2`` (``vext_bf16exp``'s exponential) gives
    on the card for every bf16 input, as fp32 indexed by the input's bit
    pattern (:func:`bf16_bits`); one launch of a table kernel of
    ``csrc/attention_variants.cu``, not counted in ``launches``."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the table is read from the card's instruction: needs a CUDA "
                         f"device, not {device}")
    fn = _table_kernel()
    out = torch.empty(2 ** 16, dtype=torch.bfloat16, device=device)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the ex2.approx.ftz.bf16x2 table failed with CUDA error {err}")
    return out.float()


def attention_variant_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    variant: str,
    layout: str,
) -> torch.Tensor:
    """Plain PyTorch version of ``variant`` in ``layout``, in q's shape and
    dtype. Rounding points, as the kernel's:

    - all but "dma": q roped in fp32, times ``scale``, rounded to q's dtype
      once; k roped in fp32 and rounded once; s = q . k^T in fp32 (the
      steps of ``flash_attention._attend``, which K1-K3's plain versions run);
    - "qk": s rounded to the output dtype;
    - "nosm": p = s rounded; p . V summed in fp32, rounded;
    - "pipe": ``_attend`` itself: p = exp(s - max) in fp32, rounded before
      p . V, the row sum of the unrounded p in fp32;
    - "vext", "vext_bf16exp": the kernel's own loop (:func:`online_softmax`):
      64-key tiles against a running max; "vext" p = bf16(2^x), x = s
      log2(e) - max log2(e) in fp32; "vext_bf16exp" x rounded to bf16 and
      p = 2^x correctly rounded; the row sum is of the rounded p (p . 1);
      o = acc (1 / lsum), rounded.

    "dma" returns q itself, copied."""
    B, N, H, d = _shape(q, layout)
    if variant not in _VARIANT_CODES:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if variant == "dma":
        return q.clone()
    nv = N if n_valid is None else n_valid
    out = _variant_heads(variant, to_heads(q, layout), to_heads(k, layout), to_heads(v, layout),
                         scale, nv, rope_cos, rope_sin, q.dtype)
    return from_heads(out.to(q.dtype), layout)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_attention_variants`` of ``csrc/attention_variants.cu``,
    built at first use: K3's signature (``flash_attention._kernel``), then
    heads_per_group and the variant's code."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_variants").cbas_attention_variants
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int,
    ]
    return fn


# The threads (a consumer warpgroup and a producer warp), ring stages and
# blocks an SM the Hopper body's build is compiled for (csrc/
# attention_sm90.cuh's Config and Launch), by head dim: variant 0 ("full",
# K1-K3's own loop) and every variant but the pipe loop's, then the pipe
# loop's.
BODY_LAUNCH = {64: {"threads": 160, "stages": 2, "min_blocks": 4},
               128: {"threads": 160, "stages": 2, "min_blocks": 3}}
PIPE_LAUNCH = {64: {"threads": 160, "stages": 4, "min_blocks": 2},
               128: {"threads": 160, "stages": 4, "min_blocks": 1}}


def launch_config(variant: str, head_dim: int) -> dict:
    """How ``variant``'s build at ``head_dim`` (64 or 128) is launched, as
    the wrapper expects it: {"threads", "stages", "min_blocks"}
    (``"full"``: variant 0). :func:`library_launch_config` reads what the
    built library says."""
    if head_dim not in BODY_LAUNCH or variant not in ("full", *_VARIANT_CODES):
        raise ValueError(f"no variant {variant!r} at head dim {head_dim}")
    return dict((PIPE_LAUNCH if variant == "pipe" else BODY_LAUNCH)[head_dim])


def library_launch_config(variant: str, head_dim: int) -> dict:
    """What the built library reports for ``variant`` at ``head_dim``
    (``"full"``: variant 0): {"threads", "stages", "min_blocks",
    "smem_bytes", "resident_blocks"}, the last the blocks of its rank-4
    kernel the card keeps on an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Needs the card;
    raises where the library refuses."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_variants").cbas_attention_variant_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5
    vals = [ctypes.c_int(-1) for _ in range(5)]
    code = 0 if variant == "full" else _VARIANT_CODES[variant]
    err = fn(code, head_dim, *(ctypes.byref(x) for x in vals))
    if err:
        raise RuntimeError(f"attention_variants reports no build of {variant} at {head_dim} "
                           f"(CUDA error {err})")
    return dict(zip(("threads", "stages", "min_blocks", "smem_bytes", "resident_blocks"),
                    (x.value for x in vals)))


@functools.lru_cache(maxsize=None)
def _table_kernel():
    """The C entry ``cbas_ex2_bf16x2_table`` of ``csrc/attention_variants.cu``."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_variants").cbas_ex2_bf16x2_table
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _launch(variant, layout, q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, d) -> torch.Tensor:
    """Launch ``variant``'s kernel on CUDA tensors, or raise. The output (and
    the roped keys' scratch, where the variant ropes) is allocated dense in
    q's dim order, as ``flash_attention._launch`` allocates K1-K3's."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernel path needs a CUDA tensor, not one on {q.device}")
    cos = sin = None
    if rope_cos is not None and variant != "dma":
        cos = rope_cos.to(torch.float32).contiguous()
        sin = rope_sin.to(torch.float32).contiguous()
    fa._require_contiguous(rope_cos=cos, rope_sin=sin)
    heads_per_group = {"fat": H, "packed": 2, "headmajor": 1}[layout]
    body = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        out = fa._dense_like(q)
        k_scratch = fa._dense_like(q) if cos is not None else None
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin, None, k_scratch)),
            B, N, H, d, *fa._layout(q), *fa._layout(out), nv, float(scale), 1,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(body), heads_per_group,
            _VARIANT_CODES[variant],
        )
    if err:
        raise RuntimeError(f"attention_variants ({variant}) launch failed with CUDA error {err}")
    if body.value != 1:
        raise RuntimeError(f"attention_variants ({variant}) did not run the Hopper body")
    _count_launch(variant)
    return out


def _count_launch(variant: str) -> None:
    global launches
    with _count_lock:
        launches += 1
        launches_by_variant[variant] = launches_by_variant.get(variant, 0) + 1


def attention_variant(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    variant: str,
    layout: str,
) -> torch.Tensor:
    """``variant`` of the attention body over q, k and v in ``layout``;
    returns q's shape and dtype, dense in q's dim order.

    bfloat16 only, head dim 64 (128 too in "headmajor"); q, k and v may be
    strided views under K1-K3's rule (one set of strides, the last dim
    contiguous, the others and the base addresses 16-byte multiples, no
    overlap). ``rope_cos``/``rope_sin`` are (N, d) tables. Raises
    ``ValueError`` on anything else, on every device."""
    if variant not in _VARIANT_CODES:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    B, N, H, d = _shape(q, layout)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the variants are built for bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS[layout]:
        raise ValueError(f"the {layout} variants are built at head dims {HEAD_DIMS[layout]}, "
                         f"not {d}")
    nv = fa._check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    fa._check_strides(("q", "k", "v"), q, k, v, math.gcd(16, d * q.element_size()))
    if q.device.type == "cpu":
        return fa._in_dense_order(q, attention_variant_reference(
            q, k, v, scale, nv, rope_cos, rope_sin, variant=variant, layout=layout))
    return _launch(variant, layout, q, k, v, scale, nv, rope_cos, rope_sin, B, N, H, d)


# The two-consumer body (csrc/attention_sm90_ws.cuh) at 128 as a timing case
# beside K3's one-warpgroup body at that width.
WS_WIDTH = 128
launches_ws = 0  # launches of ws_attention's kernel


@functools.lru_cache(maxsize=None)
def _ws_kernel():
    """The C entry ``cbas_attention_ws_variant`` of ``csrc/attention_variants.cu``:
    K3's signature up to the stream."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_variants").cbas_attention_ws_variant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return fn


def ws_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3's function (``fa.fused_attention``) on head-major (B, H, N, d) bf16
    q, k and v through the two-consumer body built at 128. No route calls
    it: it times the body beside K3's one-warpgroup body at that width.
    64 < d <= 128 with d % 16 == 0 (maps at d, no staging); strides under
    K3's rule, the maps of rank 4 (not contiguous packed). On a CPU tensor
    the plain K3; on a CUDA one the kernel, or raise."""
    if q.dim() != 4 or q.dtype != torch.bfloat16:
        raise ValueError(f"expected head-major bf16 (B, H, N, d), got {tuple(q.shape)} {q.dtype}")
    B, H, N, d = q.shape
    if not WS_WIDTH - 64 < d <= WS_WIDTH or d % 16:
        raise ValueError(f"the two-consumer body's timing entry takes d from {WS_WIDTH - 48} to "
                         f"{WS_WIDTH} in steps of 16, not {d}")
    nv = fa._check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    fa._check_strides(("q", "k", "v"), q, k, v, 16, 16)
    if q.device.type == "cpu":
        return fa._in_dense_order(q, fa.attention_headmajor_reference(
            q, k, v, scale, nv, rope_cos, rope_sin))
    if q.device.type != "cuda":
        raise ValueError(f"ws_attention runs on cpu or cuda, not {q.device}")
    cos = sin = None
    if rope_cos is not None:
        cos, sin = (t.to(torch.float32).contiguous() for t in (rope_cos, rope_sin))
    fa._require_contiguous(rope_cos=cos, rope_sin=sin)
    with torch.cuda.device(q.device):
        out = fa._dense_like(q)
        q_scratch = k_scratch = None
        if cos is not None:  # the RoPE prologue's scratch, as K3 allocates it
            k_scratch = fa._dense_like(q)
            q_scratch = fa._dense_like(q) if d < WS_WIDTH else None
        err = _ws_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin, q_scratch, k_scratch)),
            B, N, H, d, *fa._layout(q), *fa._layout(out), nv, float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"ws_attention failed with CUDA error {err}")
    global launches_ws
    with _count_lock:
        launches_ws += 1
    return out
