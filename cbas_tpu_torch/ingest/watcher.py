"""Recording-directory watcher: new videos -> encode queue, after settling.

The reference uses a watchdog Observer with a 10s cool-down so ffmpeg finishes
writing each segment before it is queued (backend/workthreads.py:1174-1224).
This implementation is dependency-free: a polling scanner that tracks file
sizes/mtimes and promotes a file once it has been stable for ``settle_s``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Set


class RecordingWatcher(threading.Thread):
    def __init__(
        self,
        root: str,
        on_ready: Callable[[str], None],
        settle_s: float = 10.0,
        poll_s: float = 2.0,
        suffix: str = ".mp4",
    ):
        super().__init__(daemon=True)
        self.root = root
        self.on_ready = on_ready
        self.settle_s = settle_s
        self.poll_s = poll_s
        self.suffix = suffix
        self._stop = threading.Event()
        # path -> (size, mtime, first_seen_stable)
        self._pending: Dict[str, tuple] = {}
        self._known: Set[str] = set()
        # path -> consecutive scans it was absent from disk; entries are
        # purged after a few misses so dedupe state doesn't grow without
        # bound over multi-week recording sessions with manual deletions
        self._missing: Dict[str, int] = {}
        self._lock = threading.Lock()

    def prime_existing(self) -> None:
        """Mark files that already exist as known (don't re-queue them)."""
        for path in self._scan():
            self._known.add(path)

    def forget(self, path: str) -> None:
        """Drop a path from dedup tracking (it may be queued again later)."""
        with self._lock:
            self._known.discard(path)
            self._pending.pop(path, None)

    def mark_handled(self, path: str) -> None:
        """Record a path as already queued by someone else (imports, final
        recording segments): the watcher must NOT promote it again — the
        opposite of :meth:`forget` (which re-arms tracking and caused every
        imported video to be encoded twice)."""
        with self._lock:
            self._known.add(path)
            self._pending.pop(path, None)

    def stop(self) -> None:
        self._stop.set()

    def _scan(self):
        from cbas_tpu_torch.utils.naming import is_staging_artifact

        for dirpath, _, files in os.walk(self.root):
            for name in files:
                # *.tmp.mp4 are in-progress standardize/augment outputs:
                # a slow write that stalls past settle_s must not be
                # promoted (and encoded) mid-write.
                if name.endswith(self.suffix) and not is_staging_artifact(name):
                    yield os.path.join(dirpath, name)

    def poll_once(self, now: Optional[float] = None) -> int:
        """One scan cycle; returns how many files were promoted. Testable."""
        now = now if now is not None else time.monotonic()
        # The tree walk and os.stat calls run OUTSIDE the lock (a large
        # recordings tree would otherwise block forget()/mark_handled()
        # callers for the whole scan), as do the on_ready callbacks (a
        # handler touching the watcher would deadlock the non-reentrant
        # lock). Only the dedupe-state updates are locked.
        stats = []
        for path in self._scan():
            try:
                st = os.stat(path)
            except OSError:
                continue
            stats.append((path, (st.st_size, st.st_mtime)))
        ready = []
        with self._lock:
            for path, sig in stats:
                if path in self._known:
                    continue
                prev = self._pending.get(path)
                if prev is None or prev[:2] != sig:
                    self._pending[path] = (*sig, now)
                    continue
                if now - prev[2] >= self.settle_s:
                    self._known.add(path)
                    del self._pending[path]
                    ready.append(path)
            # Purge tracking for files deleted from disk (after 3 straight
            # absent scans — a freshly mark_handled import may not have
            # materialized yet, and one scan can race the writer). A path
            # that reappears later is a new file and is tracked afresh.
            seen = {p for p, _ in stats}
            for path in list(self._known) + list(self._pending):
                if path in seen:
                    self._missing.pop(path, None)
                    continue
                misses = self._missing.get(path, 0) + 1
                if misses >= 3:
                    self._known.discard(path)
                    self._pending.pop(path, None)
                    self._missing.pop(path, None)
                else:
                    self._missing[path] = misses
        for path in ready:
            try:
                self.on_ready(path)
            except Exception as e:
                # log_message, not print: the path is already in _known (never
                # retried), so this line is the only explanation the app log
                # will ever have for a permanently missing embedding.
                from cbas_tpu_torch.utils.logging import log_message

                log_message(f"Watcher on_ready failed for {path}: {e}", "ERROR")
        return len(ready)

    def run(self) -> None:
        self.prime_existing()
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_s)
