"""Structured logging with a bounded UI fan-out queue.

Copy of ``cbas_tpu/utils/logging.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Mirrors the reference's ``log_message`` + bounded ``log_queue`` channel
(reference: backend/workthreads.py:74-96, backend/gui_state.py:104-110) but as a
self-contained module: console logging always works, and an optional bounded
queue lets a UI forwarder drain messages without ever blocking workers.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Optional

_print_lock = threading.Lock()

# Bounded queue for UI forwarding; messages are dropped (never block) when full.
LOG_QUEUE_MAX = 1000
log_queue: "queue.Queue[str]" = queue.Queue(maxsize=LOG_QUEUE_MAX)

_LEVELS = ("DEBUG", "INFO", "WARN", "ERROR")


def log_message(message: str, level: str = "INFO", *, to_queue: bool = True) -> str:
    """Log a message to stdout and (best-effort) the bounded UI queue.

    Returns the formatted line for callers that want to re-emit it.
    """
    if level not in _LEVELS:
        level = "INFO"
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    line = f"[{ts}] [{level}] {message}"
    with _print_lock:
        out = sys.stderr if level == "ERROR" else sys.stdout
        print(line, file=out, flush=True)
    if to_queue:
        try:
            log_queue.put_nowait(line)
        except queue.Full:
            # UI log messages are advisory; dropping beats blocking a worker.
            pass
    return line


def drain_log_queue(max_items: Optional[int] = None) -> list[str]:
    """Pop up to ``max_items`` pending log lines (all if None)."""
    out: list[str] = []
    while max_items is None or len(out) < max_items:
        try:
            out.append(log_queue.get_nowait())
        except queue.Empty:
            break
    return out
