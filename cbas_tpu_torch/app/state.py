"""Shared application state: task queues, locks, live-inference selection.

The reference keeps this as module globals with convention-based locking
(backend/gui_state.py). Here it is one object with explicit lock-guarded
queue operations, so workers and tests can own isolated instances; a module
singleton preserves the convenient global access pattern.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch


class TaskQueue:
    """A lock-guarded FIFO of file paths with dedupe on append."""

    def __init__(self) -> None:
        self._items: List[str] = []
        self._lock = threading.Lock()

    def append(self, item: str) -> bool:
        with self._lock:
            if item in self._items:
                return False
            self._items.append(item)
            return True

    def extend(self, items) -> int:
        return sum(self.append(i) for i in items)

    def pop(self) -> Optional[str]:
        with self._lock:
            return self._items.pop(0) if self._items else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def snapshot(self) -> List[str]:
        with self._lock:
            return list(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def drain(self) -> int:
        """Clear and report how many items were dropped (one lock hold)."""
        with self._lock:
            n = len(self._items)
            self._items.clear()
            return n


class Callbacks:
    """UI event fan-out: named callbacks, all optional, never raising.

    Replaces the reference's direct ``eel.<jsFunc>()()`` calls so the same
    workers serve the websocket frontend, tests, and headless runs.
    """

    def __init__(self) -> None:
        self._fns: Dict[str, Callable] = {}
        self._listeners: list = []  # wildcard (name, args) subscribers (SSE)

    def register(self, name: str, fn: Callable) -> None:
        self._fns[name] = fn

    def add_listener(self, fn: Callable) -> None:
        """Subscribe to every event as fn(name, args_tuple)."""
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def emit(self, name: str, *args) -> None:
        fn = self._fns.get(name)
        if fn is not None:
            try:
                fn(*args)
            except Exception as e:  # UI failures must never kill workers
                print(f"Callback '{name}' failed: {e}")
        for listener in list(self._listeners):
            try:
                listener(name, args)
            except Exception:
                pass


class AppState:
    """Everything the worker threads share."""

    def __init__(self, device="cuda") -> None:
        self.project = None  # cbas_tpu_torch.core.project.Project
        self.encoder = None  # cbas_tpu_torch.models.encoder.FrameEncoder
        self.device = torch.device(device)  # where every engine runs without a mesh
        self.mesh = None  # parallel.mesh.Mesh when >1 device (parallel/mesh.py)

        self.encode_tasks = TaskQueue()
        self.classify_tasks = TaskQueue()

        self.live_inference_model_name: Optional[str] = None
        # True while an explicit start_classification batch is draining: only
        # such batches clear the live model at completion — live-chaining
        # single segments during recording must keep it selected.
        self.batch_classification_active = False

        self.training_cancel = threading.Event()
        self.shutdown = threading.Event()

        self.callbacks = Callbacks()

        # Encode batch progress counters (two-tier overlay in the UI).
        self.encode_batch_total = 0
        self.encode_batch_done = 0
        self._counter_lock = threading.Lock()

        # Labeling session state lives in app.labeling.LabelingSession.
        self.labeling_session = None

        # Stale-visualization suppression (reference: gui_state.py:97-99).
        self.latest_viz_task_id = 0
        self.viz_lock = threading.Lock()

    def note_encode_queued(self, n: int = 1) -> None:
        with self._counter_lock:
            if self.encode_batch_total == self.encode_batch_done:
                self.encode_batch_total, self.encode_batch_done = 0, 0
            self.encode_batch_total += n

    def note_encode_done(self) -> None:
        with self._counter_lock:
            self.encode_batch_done += 1

    def encode_progress(self) -> tuple:
        with self._counter_lock:
            return self.encode_batch_done, self.encode_batch_total


# Module-level singleton for app wiring; tests create their own instances.
app_state = AppState()
