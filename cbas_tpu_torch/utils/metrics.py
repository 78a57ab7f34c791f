"""Per-stage throughput counters and profiler hooks.

Copy of ``cbas_tpu/utils/metrics.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

The reference has no tracing or throughput accounting (SURVEY.md §5). Here
every pipeline stage reports into a process-wide registry — decode frames/s,
encode frames/s, inference windows/s, train steps/s — queryable through the
API (`get_metrics`) and printable for benchmarks. ``trace()`` wraps
``torch.profiler`` for on-demand device traces (the original wraps
``jax.profiler``). The registry is the port's own: nothing reads it unless
the caller wiring the port in does.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import Dict, Optional


class StageMeter:
    """Counts units of work and busy seconds for one pipeline stage."""

    __slots__ = ("units", "busy_s", "last_update", "_lock")

    def __init__(self) -> None:
        self.units = 0.0
        self.busy_s = 0.0
        self.last_update = 0.0
        self._lock = threading.Lock()

    def add(self, units: float, seconds: float) -> None:
        with self._lock:
            self.units += units
            self.busy_s += seconds
            self.last_update = time.time()

    @property
    def rate(self) -> float:
        return self.units / self.busy_s if self.busy_s > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "units": self.units,
                "busy_s": round(self.busy_s, 3),
                "rate": round(self.rate, 2),
                "last_update": self.last_update,
            }


class MetricsRegistry:
    def __init__(self) -> None:
        self._meters: Dict[str, StageMeter] = {}
        # First-touch meter creation must be locked: two pipeline threads
        # racing defaultdict.__missing__ could each build a StageMeter and
        # one instance's counts would be silently orphaned.
        self._lock = threading.Lock()

    def meter(self, name: str) -> StageMeter:
        m = self._meters.get(name)
        if m is None:
            with self._lock:
                m = self._meters.setdefault(name, StageMeter())
        return m

    def add(self, name: str, units: float, seconds: float) -> None:
        self.meter(name).add(units, seconds)

    @contextlib.contextmanager
    def timed(self, name: str, units: float = 1.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, units, time.perf_counter() - t0)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: m.snapshot() for k, m in sorted(self._meters.items())}

    def reset(self) -> None:
        self._meters.clear()


metrics = MetricsRegistry()

# Canonical stage names used across the pipeline.
DECODE_FRAMES = "decode_frames"          # host video decode
ENCODE_FRAMES = "encode_frames"          # frames through the ViT (warm programs)
ENCODE_FRAMES_COLD = "encode_frames_cold"  # batches that paid XLA compilation
INFER_WINDOWS = "infer_windows"          # sliding windows through the head
INFER_FRAMES = "infer_frames"            # frames with predictions written
TRAIN_STEPS = "train_steps"              # optimizer steps
H5_ROWS = "h5_rows_written"              # embedding rows persisted


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace (host, and the card's kernels where
    there is one) around a code region.

    Usage: ``with trace('traces'): run_workload()`` then open
    ``traces/trace.json`` in chrome://tracing or Perfetto. The default
    directory is under the temporary directory. No-op (with a warning) if the
    profiler is unavailable.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "cbas-torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
        started = True
    except Exception as e:  # profiling not supported here
        print(f"torch.profiler unavailable: {e}")
        started = False
    try:
        yield log_dir
    finally:
        if started:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, "trace.json")
                prof.export_chrome_trace(path)
                print(f"trace written to {path}")
            except Exception:
                pass
