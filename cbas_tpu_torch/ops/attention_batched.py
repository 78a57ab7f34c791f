"""The batched whole-row attention, a timing kernel beside K1-K3.

Port of the head-major batched probes of ``benchmarks/attn_probes/``, which
keep a (b, h) item's whole K and V resident, take an exact softmax against
the row's true max and batch several items into one program. Each probe body
is an option set of one kernel (``csrc/attention_batched.cu``):

- ``probe13_batched_dot_256.py`` (``make``'s ``pallas_call``):
  ``qk_kernel`` (per head pair on packed blocks) and ``qk_batched_kernel``
  are ``stage="qk"`` on head-pair packed and head-major views;
  ``full_batched_kernel`` is ``stage="full"`` on head-major tensors roped and
  scaled outside by :func:`rope_outside`; its ``dma_kernel`` is the memory
  floor (``ops/memory_floor.py``);
- ``probe16_variants_marginal_256.py``'s ``full_batched_kernel``: the same,
  with RoPE outside and without;
- ``probe21_batched_model_256.py``'s ``make_batched_kernel``: ``stage=
  "full"`` with ``tables`` from :func:`rope_tables` (q's scaled by the
  softmax scale, k's by sqrt(d) after it), RoPE inside;
- ``probe26_layouts_256.py``: ``batched_kernel`` is ``score_scale=d**-0.5``;
  ``batched_kt_kernel`` the same with ``k_transposed``; ``fatq_kt_kernel``
  the same on a flat q view with ``k_transposed`` and ``v_transposed`` and a
  head-major ``out``; its ``relayout_kt_kernel`` is ``ops/relayout.py``;
- ``probe26b_gbbatch_256.py``'s ``gbbatch_kernel``: flat q, k, v and out,
  ``items`` = gb images x the heads, ``score_scale=d**-0.5``, RoPE inside
  with the plain tables (``rope_tables(cos, sin)``) or none;
- the flat probes, K1's TPU body per (image, head) with RoPE inside (q's
  tables times the scale, k's plain, which at d 64 are probe21's tables):
  ``probe18_fat768_256.py:107`` ``fat_kernel`` (``:47``) and
  ``probe18b_unroll_256.py:158`` ``fat_kernel`` (``:47``) are ``"full"``
  with ``tables`` at 48 items (gb 4 images) a block on flat views, their
  ``pvt=True`` and probe18b's ``fat_kernel_unroll`` (``:104``) the same with
  ``transposed_scores``; ``probe19_fat_gridpair_256.py:88`` ``kernel``
  (``:39``) the same at 16 items on ``t.view(B, N, H // 2, 2, 64).permute(2,
  0, 3, 1, 4)`` views (a block's items in (pair, image, head) order);
  ``probe20_fat_model_256.py:95`` ``make_fat_kernel`` (``:40``, pvt off and
  on) and ``probe21_batched_model_256.py:160`` ``make_fat_kernel`` (``:118``,
  pvt) the two in the model (``chip_smoke.flat_model_case``); their
  ``dma_kernel`` (probe18 ``:102``, probe18b ``:153``) is the memory floor;
  ``probe24_pairrope_256.py:36``'s ``_fat_kernel_pairrope`` is K1's Pallas
  body, ported as K1;
- ``probe12_phase_split_256.py:139`` ``phase_kernel`` (``:49``) is
  ``stage="split"`` with ``tables`` at 16 items a block on head-pair packed
  views, ``transposed_scores`` for its ``pvt``, ``noexp`` for its ``noexp``.

What bounds them on the card: the bytes of q, k, v and o (0.64 GB at 384
images x 12 heads, N 272: 0.19 ms at 3.35 TB/s, against 0.09 ms of bf16
FLOP), and each block's latency chain. The design, the shared memory and
the registers of each option set are in the source's note.

The function, per item (:func:`attention_batched_reference`, whose rounding
points the kernel follows):

- ``"full"``: q and k roped in bf16 arithmetic where ``tables`` are given
  (:func:`rope_bf16`); s = q . k^T in fp32, times ``score_scale``; keys at or
  past ``n_valid`` -> -1e30 by select (their k rows read as zero); m = the
  row's max; p = exp(s - m) in fp32; o = (bf16(p) . V) / sum(p), V's dead rows
  zero; rounded to bf16. An exact softmax: no running max.
- ``"qk"``: o = q (the kernel forms every score and keeps it live).
- ``"split"``: ``"full"``'s function, the scores formed once into shared
  memory; ``noexp``: p = s - m, every key below N in the row sum (a dead one
  adds -1e30 - m, so |o| is of order 1e-28).
- ``transposed_scores``: s^T = k . q^T, its max and sums down the columns,
  o^T = V^T . P^T: the same function (the probes' ``pvt``).

Operands are (B, H, N, 64) views (head-major, or ``t.view(B, N, H, 64)
.transpose(1, 2)`` of a flat tensor) or (B, G, P, N, 64) ones (head-pair
packed: ``t.view(B, G, N, 2, 64).transpose(2, 3)``), each under its own
strides (the last dim contiguous, the others and the base 16-byte
multiples, no overlap); a transposed k or v is (B, H, 64, N) (or (B, G, P,
64, N)). N <= 320, bf16 only. The output is ``out`` if given, else dense in
q's dim order.

- On a CUDA tensor :func:`attention_batched` launches the kernel or raises;
  it does not fall back.
- On a CPU tensor it runs the plain version, which the tests hold against the
  probes' kernels.

``launches`` counts kernel launches and nothing else (``launches_by_option``
by option set, :func:`option_set`), under a lock. No encode route calls it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from cbas_tpu_torch.ops import flash_attention as fa

HEAD_DIM = 64
MAX_N = 320  # five 64-key tiles of K and V resident a block
STAGES = ("full", "qk", "split")
# The option sets the kernel is built for, each one a probe runs: (stage, RoPE
# inside, k transposed, v transposed, scores transposed, noexp).
BUILT = {("full", False, False, False, False, False), ("full", True, False, False, False, False),
         ("full", False, True, False, False, False), ("full", False, True, True, False, False),
         ("qk", False, False, False, False, False), ("full", True, False, False, True, False),
         ("split", True, False, False, False, False), ("split", True, False, False, True, False),
         ("split", True, False, False, False, True), ("split", True, False, False, True, True)}
MASKED = -1e30

launches = 0
launches_by_option: dict = {}
_count_lock = threading.Lock()


def option_set(stage: str, rope: bool, k_transposed: bool, v_transposed: bool,
               transposed_scores: bool = False, noexp: bool = False) -> str:
    """The name an option set's launches are counted under, e.g. "full+rope",
    "full+kT+vT", "qk", "full+rope+sT", "split+rope+sT+noexp"."""
    return (stage + "+rope" * rope + "+kT" * k_transposed + "+vT" * v_transposed
            + "+sT" * transposed_scores + "+noexp" * noexp)


def rope_bf16(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in bf16 arithmetic, as the probes compute it: t cos + rot(t) sin
    with bf16 ``t`` and bf16 tables, each product and the sum rounded to bf16
    (the kernel's form inside, and the probes' ``rope_xla`` outside)."""
    return t * cos + fa.rotate_half(t) * sin


def rope_outside(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """probe13's and probe16's ``rope_xla`` (then ``* scale`` for q), plain
    torch before the kernel: the fp32 tables cast to ``t``'s dtype, each
    product and the sum rounded, the scale a bf16 product."""
    out = rope_bf16(t, cos.to(t.dtype), sin.to(t.dtype))
    return out if scale is None else out * torch.tensor(scale, dtype=t.dtype)


def rope_tables(cos: torch.Tensor, sin: torch.Tensor, q_scale: float = 1.0,
                k_factor: float = 1.0) -> tuple:
    """The kernel's RoPE tables (cq, sq, ck, sk), bf16 (N, 64), contiguous,
    from fp32 (N, 64) ones: q's are bf16(cos * q_scale) (products in fp32),
    k's bf16((cos * q_scale) * k_factor). probe21's: ``q_scale`` the softmax
    scale, ``k_factor`` sqrt(d); probe26b's: both 1."""
    c, s = cos.float() * q_scale, sin.float() * q_scale
    k = torch.tensor(k_factor, dtype=torch.float32)
    return tuple(t.to(torch.bfloat16).contiguous() for t in (c, s, c * k, s * k))


def _as5(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, r, c) operand as (B, 1, H, r, c): one group of H heads."""
    return t.unsqueeze(1) if t.dim() == 4 else t


def attention_batched_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    score_scale: float = 1.0,
    tables: Optional[Sequence[torch.Tensor]] = None,
    *,
    stage: str = "full",
    k_transposed: bool = False,
    v_transposed: bool = False,
    transposed_scores: bool = False,
    noexp: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, in q's shape and dtype (rounding points in the
    module docstring): RoPE in bf16 arithmetic, s in fp32, the exact softmax
    in fp32 (p = s - m under ``noexp``), p rounded to bf16 before p . V, the
    row sum of the unrounded p, the output rounded once. "split" is the full
    stage's function. ``transposed_scores`` forms s^T = k . q^T and reduces
    down its columns, o^T = V^T . P^T: the same function in the transposed
    orientation's own summation order."""
    if stage == "qk":
        return q.clone()
    N = q.shape[-2]
    nv = N if n_valid is None else n_valid
    kh = k.transpose(-1, -2) if k_transposed else k
    vh = v.transpose(-1, -2) if v_transposed else v
    qh = q
    if tables is not None:
        cq, sq, ck, sk = tables
        qh, kh = rope_bf16(qh, cq, sq), rope_bf16(kh, ck, sk)
    live = torch.arange(N, device=q.device) < nv
    kh = torch.where(live[:, None], kh.float(), 0.0)  # dead rows' NaN/Inf bits cannot leak
    vh = torch.where(live[:, None], vh.float(), 0.0)
    if transposed_scores:  # keys down the rows
        s = torch.where(live[:, None], (kh @ qh.float().transpose(-1, -2)) * score_scale, MASKED)
        x = s - s.amax(dim=-2, keepdim=True)
        p = x if noexp else torch.exp(x)
        out = (vh.transpose(-1, -2) @ p.to(torch.bfloat16).float()) / p.sum(dim=-2, keepdim=True)
        return out.transpose(-1, -2).to(q.dtype)
    s = torch.where(live, (qh.float() @ kh.transpose(-1, -2)) * score_scale, MASKED)
    x = s - s.amax(dim=-1, keepdim=True)
    p = x if noexp else torch.exp(x)
    out = (p.to(torch.bfloat16).float() @ vh) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_attention_batched`` of ``csrc/attention_batched.cu``,
    built at first use."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_batched").cbas_attention_batched
    fn.restype = ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [strides] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _strides(t: torch.Tensor):
    """(image, group, head in group, row) element strides of a 5-dim operand,
    as a ctypes array."""
    return (ctypes.c_longlong * 4)(*(t.stride(i) for i in range(4)))


def _launch(q5, k5, v5, o5, n_valid, score_scale, tables, stage, k_transposed, v_transposed,
            items, transposed_scores=False, noexp=False) -> None:
    """Launch the kernel on CUDA operands (5-dim views) into ``o5``, or raise."""
    if q5.device.type != "cuda":
        raise ValueError(f"the kernel path needs a CUDA tensor, not one on {q5.device}")
    B, G, P, N, _ = q5.shape
    ptrs = [t.data_ptr() for t in tables] if tables is not None else [None] * 4
    with torch.cuda.device(q5.device):
        err = _kernel()(
            q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), o5.data_ptr(), *ptrs, B, G, P, N,
            n_valid, items, *(_strides(t) for t in (q5, k5, v5, o5)), float(score_scale),
            STAGES.index(stage), int(tables is not None), int(k_transposed), int(v_transposed),
            int(transposed_scores), int(noexp), torch.cuda.current_stream().cuda_stream)
    name = option_set(stage, tables is not None, k_transposed, v_transposed, transposed_scores,
                      noexp)
    if err:
        raise RuntimeError(f"attention_batched ({name}) launch failed with CUDA error {err}")
    _count_launch(name)


def _count_launch(name: str) -> None:
    global launches
    with _count_lock:
        launches += 1
        launches_by_option[name] = launches_by_option.get(name, 0) + 1


def _check_operand(name: str, t: torch.Tensor) -> None:
    """One operand's strides under the kernels' rule (its own set: q, k and v
    need not share one)."""
    fa._check_strides((name, name, name), t, t, t)


def attention_batched(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    score_scale: float = 1.0,
    tables: Optional[Sequence[torch.Tensor]] = None,
    *,
    stage: str = "full",
    k_transposed: bool = False,
    v_transposed: bool = False,
    transposed_scores: bool = False,
    noexp: bool = False,
    items: int = 16,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The batched whole-row attention of each (b, h) item of q, k and v
    (shapes and layouts in the module docstring); ``items`` consecutive items
    (heads fastest) a block of the kernel. Returns ``out`` (written) or a new
    tensor dense in q's dim order. Raises ``ValueError`` for what the kernel
    does not take, on every device."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, not {stage!r}")
    option = (stage, tables is not None, bool(k_transposed), bool(v_transposed),
              bool(transposed_scores), bool(noexp))
    if option not in BUILT:
        raise ValueError(f"the kernel is not built for {option_set(*option)}")
    if q.dim() not in (4, 5):
        raise ValueError(f"expected (B, H, N, 64) or (B, G, P, N, 64) operands, got q of shape "
                         f"{tuple(q.shape)}")
    N, d = q.shape[-2:]
    t_shape = q.shape[:-2] + (d, N)
    for name, t, transposed in (("k", k, k_transposed), ("v", v, v_transposed), ("out", out, False)):
        if t is None:
            continue
        want = t_shape if transposed else q.shape
        if t.shape != want or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                             f"{tuple(want)} {q.dtype} {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel is built for bfloat16, not {q.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"the kernel is built at head dim {HEAD_DIM}, not {d}")
    if N > MAX_N:
        raise ValueError(f"N = {N} exceeds the {MAX_N} rows of K and V a block holds")
    nv = N if n_valid is None else int(n_valid)
    if not 1 <= nv <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if int(items) < 1:
        raise ValueError(f"items must be at least 1, not {items}")
    if tables is not None:
        if len(tables) != 4:
            raise ValueError("tables are (cq, sq, ck, sk): build them with rope_tables")
        for t in tables:
            if t.shape != (N, d) or t.dtype != torch.bfloat16 or t.device != q.device:
                raise ValueError(f"each table must be bf16 ({N}, {d}) on {q.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
        fa._require_contiguous(**{f"tables[{i}]": t for i, t in enumerate(tables)})
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t is not None:
            _check_operand(name, t)
    if q.device.type == "cpu":
        want = attention_batched_reference(q, k, v, nv, score_scale, tables, stage=stage,
                                           k_transposed=k_transposed, v_transposed=v_transposed,
                                           transposed_scores=transposed_scores, noexp=noexp)
        return fa._in_dense_order(q, want) if out is None else out.copy_(want)
    o = fa._dense_like(q) if out is None else out
    _launch(_as5(q), _as5(k), _as5(v), _as5(o), nv, score_scale, tables, stage, k_transposed,
            v_transposed, int(items), transposed_scores, noexp)
    return o
