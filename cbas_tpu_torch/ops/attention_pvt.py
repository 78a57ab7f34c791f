"""The streamed transposed-score attention, a timing kernel beside K1-K3.

Port of the transposed-score ("pvt") probes of ``benchmarks/attn_probes/``,
which run one head's whole key row at the 640x480 geometry (N 1216, 1205
live keys) with the scores transposed (s^T = k . q^T, the softmax down the
key axis, o^T = V^T . P^T) and an exact softmax against each query's true
max. Each probe body is an option set of one kernel
(``csrc/attention_pvt.cu``):

- ``probe3.py:42`` (``make_variant``) with ``pvt_kernel`` (``:60``):
  ``form="std"``;
- ``probe5.py:44`` with ``pvt_kernel`` (``:62``) at ``bf16exp`` x ``vext``:
  ``form="rounded"`` (vext off) or ``"vext"``, ``bf16exp`` as the probe's;
- ``probe6_pvt_interleaved.py:60`` with ``pvt_kernel`` (``:20``): ``"std"``,
  timed in rounds against K2 (``chip_smoke.py``);
- ``probe4.py:46`` with ``pvt_vext_kernel`` (``:118``), bf16exp off and on:
  ``"vext"`` (its ``vext_kernel`` is ``ops/attention_variants.py``'s);
- ``probe23_fat_480p.py:92``, ``make_fat_kernel``'s ``kernel`` (``:41``):
  ``"std"`` on flat views, swapped into the model (``chip_smoke.py``'s
  ``pvt_model_case``).

The function, per item (:func:`attention_pvt_reference`, whose rounding
points follow the probes'):

- q and k roped in bf16 arithmetic (``attention_batched.rope_bf16``) from
  bf16 tables (``attention_batched.rope_tables(cos, sin, d ** -0.5, d **
  0.5)``: the scale in q's, at d 64 k's exactly bf16(cos));
- s^T = k . q^T in fp32; keys at or past ``n_valid`` -> -1e30 by select,
  their V rows zero; m = each query column's max over every key;
- ``"std"``: p = exp(s - m) in fp32; l = the sum of p, unrounded; o^T =
  V^T . bf16(p) / l;
- ``"rounded"``: p = bf16(exp(s - m)); l = the sum of those bf16 p in fp32;
- ``"vext"``: the same p; l = the ones row of live keys appended to V^T, so
  the product [V^T; 1] . p gives o^T's numerator and l in one product;
- ``bf16exp`` (rounded, vext): p = exp of bf16(s - m), as the probes' ``jnp.exp``
  of a bf16 array runs on the CPU: the argument widened to fp32, exp in fp32,
  a result below 2^-126 flushed to 0, rounded to bf16. (The kernel takes
  2^bf16(x), x = s log2(e) - m log2(e), by the card's bf16 exponential: the
  argument rounds at another point, inside ``chip_smoke.pvt_tolerance``.)
- the output rounded to bf16 once.

Operands are (B, H, N, 64) views (head-major, or ``t.view(B, N, H, 64)
.transpose(1, 2)`` of a flat tensor) or (B, G, P, N, 64) ones (head-pair
packed: ``t.view(B, G, N, 2, 64).transpose(2, 3)``), each under its own
strides (the last dim contiguous, the others and the base 16-byte multiples,
no overlap); any N, bf16 only, RoPE inside only. The output is dense in
q's dim order.

- On a CUDA tensor :func:`attention_pvt` launches the kernel or raises; it
  does not fall back.
- On a CPU tensor it runs the plain version, which the tests hold against
  the probes' kernels.

On the card one call is two launches: a prologue that ropes K's live rows
into a scratch (once per key, as K1-K3's prologue does), then the attention,
which streams the roped K and V in units of (item, three query blocks).
``launches`` counts calls that launched them and nothing else
(``launches_by_option`` by option set, :func:`option_set`), under a lock. No
encode route calls it.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from cbas_tpu_torch.ops import attention_batched as ab
from cbas_tpu_torch.ops import flash_attention as fa

FORMS = ("std", "rounded", "vext")
# The option sets the kernel is built for, each one a probe runs: (RoPE
# inside, form, bf16exp).
BUILT = {(True, "std", False), (True, "rounded", False), (True, "rounded", True),
         (True, "vext", False), (True, "vext", True)}
MASKED = ab.MASKED
# The smallest normal fp32: XLA's CPU exp flushes results below it to 0.
FLUSH_BELOW = 2.0 ** -126

launches = 0
launches_by_option: dict = {}
_count_lock = threading.Lock()


def option_set(rope: bool, form: str, bf16exp: bool) -> str:
    """The name an option set's launches are counted under, e.g.
    "std+rope", "vext+rope+bf16exp"."""
    return form + "+rope" * rope + "+bf16exp" * bf16exp


def _as5(t: torch.Tensor) -> torch.Tensor:
    """A (B, H, N, 64) operand as (B, 1, H, N, 64): one group of H heads."""
    return t.unsqueeze(1) if t.dim() == 4 else t


def probabilities(x: torch.Tensor, form: str, bf16exp: bool) -> torch.Tensor:
    """p of the exponents x = s - m (fp32): exp(x) in fp32 for "std", else
    rounded to bf16 (as fp32 values); with ``bf16exp`` the exp of bf16(x) in
    fp32, flushed below 2^-126 as XLA's CPU exp is, then rounded."""
    if not bf16exp:
        p = torch.exp(x)
        return p if form == "std" else p.to(torch.bfloat16).float()
    p = torch.exp(x.to(torch.bfloat16).float())
    return torch.where(p < FLUSH_BELOW, 0.0, p).to(torch.bfloat16).float()


def attention_pvt_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    tables: Optional[Sequence[torch.Tensor]] = None,
    *,
    form: str = "std",
    bf16exp: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, in q's shape and dtype (rounding points in the
    module docstring): RoPE in bf16 arithmetic where ``tables`` are given,
    s^T = k . q^T in fp32, the column max, p and its sum in ``form``, o^T =
    V^T . bf16(p) over the sum, rounded once."""
    N = q.shape[-2]
    nv = N if n_valid is None else n_valid
    qh, kh = q, k
    if tables is not None:
        cq, sq, ck, sk = tables
        qh, kh = ab.rope_bf16(q, cq, sq), ab.rope_bf16(k, ck, sk)
    live = torch.arange(N, device=q.device) < nv
    kh = torch.where(live[:, None], kh.float(), 0.0)  # dead rows' NaN/Inf bits cannot leak
    vh = torch.where(live[:, None], v.float(), 0.0)
    s = torch.where(live[:, None], kh @ qh.float().transpose(-1, -2), MASKED)  # keys down the rows
    p = probabilities(s - s.amax(dim=-2, keepdim=True), form, bf16exp)
    P = p.to(torch.bfloat16).float()
    vt = vh.transpose(-1, -2)
    if form == "vext":  # [V^T; ones row of the live keys] . P: o^T's numerator, then the sum
        ones = torch.zeros_like(vt[..., :1, :]) + live.float()
        out = torch.cat([vt, ones], dim=-2) @ P
        ot = out[..., :-1, :] / out[..., -1:, :]
    else:
        ot = (vt @ P) / p.sum(dim=-2, keepdim=True)
    return ot.transpose(-1, -2).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_attention_pvt`` of ``csrc/attention_pvt.cu``, built at
    first use."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_pvt").cbas_attention_pvt
    fn.restype = ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [strides] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    return fn


def _launch(q5, k5, v5, o5, n_valid, tables, form, bf16exp, items) -> None:
    """Launch the kernel on CUDA operands (5-dim views) into ``o5``, or raise.
    K's roped rows go to a scratch allocated here, dense (B G P, N, 64)."""
    if q5.device.type != "cuda":
        raise ValueError(f"the kernel path needs a CUDA tensor, not one on {q5.device}")
    B, G, P, N, d = q5.shape
    with torch.cuda.device(q5.device):
        k_roped = torch.empty(B * G * P, N, d, dtype=q5.dtype, device=q5.device)
        err = _kernel()(
            q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), o5.data_ptr(),
            *(t.data_ptr() for t in tables), k_roped.data_ptr(), B, G, P, N, n_valid, items,
            *(ab._strides(t) for t in (q5, k5, v5, o5)), FORMS.index(form), int(bf16exp),
            torch.cuda.current_stream().cuda_stream)
    name = option_set(True, form, bf16exp)
    if err:
        raise RuntimeError(f"attention_pvt ({name}) launch failed with CUDA error {err}")
    _count_launch(name)


def _count_launch(name: str) -> None:
    global launches
    with _count_lock:
        launches += 1
        launches_by_option[name] = launches_by_option.get(name, 0) + 1


def attention_pvt(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: Optional[int] = None,
    tables: Optional[Sequence[torch.Tensor]] = None,
    *,
    form: str = "std",
    bf16exp: bool = False,
    items: int = 16,
) -> torch.Tensor:
    """The streamed transposed-score attention of each (b, h) item of q, k
    and v (shapes and layouts in the module docstring); the kernel's grid is
    B H / ``items`` blocks, each doing the work of ``items`` items (the
    probes' heads a program). Returns a new tensor dense in q's dim order.
    Raises ``ValueError`` for what the kernel does not
    take, on every device."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    option = (tables is not None, form, bool(bf16exp))
    if option not in BUILT:
        raise ValueError(f"the kernel is not built for {option_set(*option)}")
    if q.dim() not in (4, 5):
        raise ValueError(f"expected (B, H, N, 64) or (B, G, P, N, 64) operands, got q of shape "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the kernel is built for bfloat16, not {q.dtype}")
    N, d = q.shape[-2:]
    if d != ab.HEAD_DIM:
        raise ValueError(f"the kernel is built at head dim {ab.HEAD_DIM}, not {d}")
    nv = N if n_valid is None else int(n_valid)
    if not 1 <= nv <= N:
        raise ValueError(f"n_valid={n_valid} outside [1, {N}]")
    if int(items) < 1:
        raise ValueError(f"items must be at least 1, not {items}")
    if len(tables) != 4:
        raise ValueError("tables are (cq, sq, ck, sk): build them with attention_batched.rope_tables")
    for t in tables:
        if t.shape != (N, d) or t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"each table must be bf16 ({N}, {d}) on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    fa._require_contiguous(**{f"tables[{i}]": t for i, t in enumerate(tables)})
    for name, t in (("q", q), ("k", k), ("v", v)):
        ab._check_operand(name, t)
    if q.device.type == "cpu":
        return fa._in_dense_order(q, attention_pvt_reference(q, k, v, nv, tables, form=form,
                                                             bf16exp=bf16exp))
    o = fa._dense_like(q)
    _launch(_as5(q), _as5(k), _as5(v), _as5(o), nv, tables, form, bool(bf16exp), int(items))
    return o
