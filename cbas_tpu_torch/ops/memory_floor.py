"""The memory floor: ``o = q + 0*k + 0*v`` over three equal tensors.

Port of the TPU kernel ``dma_kernel`` of
``benchmarks/attn_probes/probe14_dma_floor_256.py`` (its ``pallas_call``
sites in ``make_dma`` and ``make_dma_flat2d``) and of
``probe15_marginal_256.py`` (``f_dma``): it reads q, k and v once and writes
o once, the bytes of one attention call with none of its arithmetic, so its
time is the card's floor for those bytes. ``chip_smoke.py`` times it at the
bytes of every attention row of ``PERF.md`` beside the row's bound at the
card's peak memory rate.

It computes the expression, not a copy: a NaN or an Inf in k or v makes o
NaN, and q's -0 becomes +0 where k or v is non-negative.

- On a CUDA tensor :func:`memory_floor` launches ``csrc/memory_floor.cu``'s
  kernel (16-byte vector loads, a grid-stride loop) or raises. It does not
  fall back.
- On a CPU tensor it runs its plain PyTorch version
  (:func:`memory_floor_reference`), the expression itself, which the kernel
  equals bit for bit on the card.

The tensors are taken as (rows, width) with the last dim the width: bf16 or
fp32, one shape, dtype and device, contiguous, 16-byte aligned. ``launches``
counts kernel launches and nothing else, under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()


def memory_floor_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the expression, evaluated eagerly in q's dtype."""
    return q + k * 0 + v * 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_memory_floor`` of ``csrc/memory_floor.cu``, built at
    first use: four pointers (q, k, v, o), rows, width, the dtype code, the
    stream."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("memory_floor").cbas_memory_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                                     ctypes.c_void_p]
    return fn


def memory_floor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q + 0*k + 0*v``, a new contiguous tensor of q's shape and dtype."""
    global launches
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                             f"q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type == "cpu":
        return memory_floor_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"memory_floor runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    width = q.shape[-1] if q.dim() else 1
    with torch.cuda.device(q.device):
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        q.numel() // max(width, 1), width, _DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"memory_floor kernel launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
