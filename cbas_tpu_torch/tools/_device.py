"""The device rule every tool of the port keeps: it runs on the CUDA device
unless the caller asks for the CPU, and never falls back to the CPU."""

from __future__ import annotations

import torch


def require_device(device, cpu_flag: str = "--device cpu") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` naming CUDA
    where it is a CUDA device and none is visible. ``cpu_flag`` is how the
    caller's user asks for the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is visible; pass {cpu_flag} to run on the CPU")
    return dev
