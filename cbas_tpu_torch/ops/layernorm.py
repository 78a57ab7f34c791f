"""Row LayerNorm, alone or fused with the residual add in front of it.

Port of the TPU kernel ``benchmarks/attn_probes/probe25_ln_256.py``'s
``make_pallas_ln`` (a row LayerNorm over (B*N, D) with fp32 statistics, the
affine, and the output in the input dtype), widened to the ViT forward's use:
every LayerNorm but the first follows a residual add with a layer scale, and
:func:`add_layernorm` does both in one pass over the rows.

- :func:`add_layernorm` returns ``(x + h * lam, LN(x + h * lam))``: the
  residual stream, with ``h * lam`` rounded to x's dtype before the add as
  ``cbas_tpu/models/vit.py::_block`` rounds it, and its LayerNorm.
- :func:`layernorm` is the LayerNorm alone (block 0's ``norm1``).

The variance is single-pass (``E[x^2] - mean^2`` clamped at 0) on bf16 and
two-pass on fp32, or two-pass on both where ``CBAS_LN_TWO_PASS`` is set (read
at each call, as the JAX package reads it); ``two_pass`` overrides both.

- On a CUDA tensor each wrapper launches ``csrc/layernorm.cu``'s kernel or
  raises. Neither falls back.
- On a CPU tensor it runs its plain PyTorch version
  (:func:`add_layernorm_reference`, :func:`layernorm_reference`): the eager
  expressions the port's forward ran before the kernel, bit for bit.

The kernel takes x and h in bfloat16 or float32 at any D, and the (D,)
parameters in either dtype (read as fp32, as the plain version reads them;
lam rounded to x's dtype first, as the JAX package casts it). It reads x and
h through their row strides, so ``x[:, :1]`` of a (B, N, D) stream (the CLS
rows) is read in place; a tensor whose leading dims do not collapse to one
row stride, or whose last dim is not contiguous, is copied first. Both
outputs are new contiguous tensors of x's shape.

``launches`` counts kernel launches and nothing else, so a run can show
that its main path went through the kernel. The shards of a device mesh
launch from threads of their own, so it is updated under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()  # shard threads launch concurrently


def use_two_pass(dtype: torch.dtype, two_pass: Optional[bool] = None) -> bool:
    """Whether the variance is two-pass: ``two_pass`` where given, else
    single-pass on bfloat16 unless ``CBAS_LN_TWO_PASS`` is set (to anything
    non-empty), two-pass on every other dtype."""
    if two_pass is not None:
        return bool(two_pass)
    return dtype != torch.bfloat16 or bool(os.environ.get("CBAS_LN_TWO_PASS"))


def layernorm_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    two_pass: Optional[bool] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the LayerNorm over the last dim, in fp32,
    returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    if not use_two_pass(x.dtype, two_pass):
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    else:
        var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def add_layernorm_reference(
    x: torch.Tensor,
    h: torch.Tensor,
    lam: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    two_pass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused residual and LayerNorm:
    ``(x + h * lam, LN(x + h * lam))``, lam cast to x's dtype."""
    x = x + h * lam.to(x.dtype)
    return x, layernorm_reference(x, weight, bias, eps, two_pass)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_layernorm`` of ``csrc/layernorm.cu``, built at first
    use: seven pointers (x, h, lam, w, b, x_out, y), rows, D, x's and h's
    row strides, the dtype codes of x, lam, w and b, eps, two_pass, the
    stream."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("layernorm").cbas_layernorm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` as (rows, D) with its row stride: a view where the leading dims
    collapse to one stride and the last dim is contiguous, else a
    contiguous copy."""
    D = t.shape[-1]
    if t.stride(-1) == 1 or D == 1:
        try:
            rows = t.view(-1, D)
            return rows, rows.stride(0) if rows.shape[0] > 1 else D
        except RuntimeError:  # the leading dims do not collapse to one stride
            pass
    rows = t.contiguous().view(-1, D)
    return rows, D


def _param(name: str, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (D,) parameter on x's device in a dtype the kernel reads,
    contiguous."""
    D = x.shape[-1]
    if p.shape != (D,) or p.device != x.device:
        raise ValueError(f"{name} must be ({D},) on {x.device}, got {tuple(p.shape)} on {p.device}")
    if p.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} must be float32 or bfloat16, not {p.dtype}")
    return p.contiguous()


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _launch(x, h, lam, weight, bias, eps, two_pass):
    """Launch the kernel on CUDA tensors, or raise. ``h`` None: LayerNorm
    alone. Returns (x', y), x' None without ``h``."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {x.dtype}")
    if x.dim() == 0:
        raise ValueError("expected at least one dim (the normalised one)")
    D = x.shape[-1]
    weight, bias = _param("weight", weight, x), _param("bias", bias, x)
    xr, x_stride = _rows(x)
    hr, h_stride, x_out = None, 0, None
    if h is not None:
        if h.shape != x.shape or h.dtype != x.dtype or h.device != x.device:
            raise ValueError(f"h {tuple(h.shape)} {h.dtype} {h.device} does not match "
                             f"x {tuple(x.shape)} {x.dtype} {x.device}")
        lam = _param("lam", lam, x)
        hr, h_stride = _rows(h)
    with torch.cuda.device(x.device):
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if h is not None:
            x_out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        if y.numel() == 0:
            return x_out, y
        err = _kernel()(
            xr.data_ptr(), None if hr is None else hr.data_ptr(),
            None if h is None else lam.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if x_out is None else x_out.data_ptr(), y.data_ptr(),
            xr.shape[0], D, x_stride, h_stride, _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[lam.dtype] if h is not None else 0,
            _DTYPE_CODES[weight.dtype], _DTYPE_CODES[bias.dtype], float(eps),
            int(use_two_pass(x.dtype, two_pass)), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"layernorm kernel launch failed with CUDA error {err}")
    _count_launch()
    return x_out, y


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on cpu or cuda, not {x.device}")
    return True


def layernorm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    two_pass: Optional[bool] = None,
) -> torch.Tensor:
    """LayerNorm of x over its last dim with fp32 statistics and the (D,)
    affine, in x's dtype."""
    if not _on_cuda(x):
        return layernorm_reference(x, weight, bias, eps, two_pass)
    return _launch(x, None, None, weight, bias, eps, two_pass)[1]


def add_layernorm(
    x: torch.Tensor,
    h: torch.Tensor,
    lam: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
    two_pass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x', LN(x'))`` for ``x' = x + h * lam``: h of x's shape and dtype,
    lam the (D,) layer scale; one kernel on the card."""
    if not _on_cuda(x):
        return add_layernorm_reference(x, h, lam, weight, bias, eps, two_pass)
    return _launch(x, h, lam, weight, bias, eps, two_pass)
