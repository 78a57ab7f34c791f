"""The K-transposing relayout: flat (B, N, H*d) to (B*H, d, N), bit for bit.

Port of the TPU kernel ``relayout_kt_kernel`` of
``benchmarks/attn_probes/probe26_layouts_256.py`` (its ``pallas_call``
``f_relayout_kt``): it prices producing a transposed K, the input of the
probe's ``batched_kt_kernel`` and ``fatq_kt_kernel`` (``ops/attention_batched.py``
with ``k_transposed``), from the projection's flat output. No route calls it.

- On a CUDA tensor :func:`relayout_kt` launches ``csrc/relayout.cu``'s kernel
  (64 x 64 tiles through shared memory) or raises; it does not fall back.
- On a CPU tensor it runs its plain version, ``x.view(B, N, H, d).permute(0,
  2, 3, 1)`` made contiguous.

x is bf16, its last dim contiguous, its other strides and its base 16-byte
multiples (a strided view, such as a column block of one fused projection,
is read in place); N and H*d multiples of 8. ``launches`` counts kernel
launches and nothing else, under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from cbas_tpu_torch.ops import flash_attention as fa

launches = 0
_count_lock = threading.Lock()


def relayout_kt_reference(x: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version: (B, N, H*d) -> (B*H, d, N), contiguous."""
    B, N, D = x.shape
    return x.view(B, N, heads, D // heads).permute(0, 2, 3, 1).reshape(B * heads, D // heads, N)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_relayout_kt`` of ``csrc/relayout.cu``, built at first
    use: x, out, B, N, D, x's batch and row strides, the stream."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("relayout").cbas_relayout_kt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    return fn


def relayout_kt(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``x`` (B, N, heads*d) as a new contiguous (B*heads, d, N) tensor."""
    global launches
    if x.dim() != 3 or heads < 1 or x.shape[-1] % heads:
        raise ValueError(f"expected flat (B, N, heads*d) x, got {tuple(x.shape)} for "
                         f"{heads} heads")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the kernel is built for bfloat16, not {x.dtype}")
    B, N, D = x.shape
    if N % 8 or D % 8:
        raise ValueError(f"N ({N}) and H*d ({D}) must be multiples of 8")
    fa._check_strides(("x", "x", "x"), x, x, x)
    if x.device.type == "cpu":
        return relayout_kt_reference(x, heads)
    if x.device.type != "cuda":
        raise ValueError(f"relayout_kt runs on cpu or cuda, not {x.device}")
    with torch.cuda.device(x.device):
        out = torch.empty(B * heads, D // heads, N, dtype=x.dtype, device=x.device)
        err = _kernel()(x.data_ptr(), out.data_ptr(), B, N, D, x.stride(0), x.stride(1),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"relayout_kt kernel launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
