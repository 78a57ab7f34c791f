"""Atomic file-claim leases for zero-infrastructure work distribution.

A worker owns a unit of work iff it created ``<output>.claim`` with
O_CREAT|O_EXCL — atomic on POSIX filesystems, including the NFS-style shared
filesystems of TPU pod hosts, so the same work list can be drained by
processes on many chips or many hosts with no queue service. The claim is a
LEASE (who is working now), never a done-marker: callers must check their
own done-marker (encoder stamp, outputs CSV, report file) before claiming
and again under the lease. Claims older than a TTL are presumed dead
(crashed worker) and broken; outputs written tmp+rename make that retry safe.

Used by tools/encode_fleet.py (per-chip encode/classify fan-out) and
app/sweep.py (per-chip sweep-combo fan-out).
"""

from __future__ import annotations

import os
import threading
import time


_BREAK_GUARD_TTL_S = 60.0


def _break_stale(path: str, ttl_s: float) -> None:
    """Unlink ``path`` iff it is still stale, under a breaker guard file.

    A bare stat-then-unlink is racy: between one breaker's stat (stale) and
    its unlink, another breaker may have broken the claim AND a new owner
    re-created it — the unlink then destroys a LIVE lease (observed as two
    claim winners under thread contention). The guard (``<path>.break``,
    O_EXCL) serializes breakers, and staleness is re-checked under it; new
    claims only appear after an unlink, and only guard holders unlink, so a
    fresh claim is never seen stale by a holder. The guard clears itself
    after 60 s if its holder died (that one-level-down race window is
    milliseconds against a 60 s bound).
    """
    guard = path + ".break"
    try:
        fd = os.open(guard, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        try:
            if time.time() - os.path.getmtime(guard) > _BREAK_GUARD_TTL_S:
                os.unlink(guard)  # breaker died mid-break
        except OSError:
            pass
        return
    except OSError:
        return
    try:
        try:
            if time.time() - os.path.getmtime(path) > ttl_s:
                os.unlink(path)
        except OSError:
            pass
    finally:
        try:
            os.unlink(guard)
        except OSError:
            pass


def try_claim_path(path: str, ttl_s: float) -> bool:
    """Atomically create the claim file; True iff this process now owns it.

    A leftover claim older than ``ttl_s`` is broken (guard-serialized, see
    :func:`_break_stale`) and re-contended via the O_EXCL retry.
    """
    for _ in range(3):  # retries after a break or a vanished claim
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, f"{os.getpid()}@{time.time()}\n".encode())
            os.close(fd)
            return True
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(path)
            except OSError:
                continue  # claim vanished between open and stat: race again
            if age <= ttl_s:
                return False
            _break_stale(path, ttl_s)
    return False


def release_claim_path(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def renew_claim_path(path: str) -> None:
    """Refresh the lease's mtime. No-op if the claim vanished (broken)."""
    try:
        os.utime(path)
    except OSError:
        pass


class ClaimHeartbeat:
    """Keep a lease alive while its owner works.

    Claims are broken by mtime age, so a worker whose single work item
    outlives the TTL (a very long video, a multi-hour sweep combo) would have
    its LIVE lease broken and a second worker would start writing the same
    output. This context manager touches the claim every ``ttl_s / 4``
    (clamped to [5 s, 300 s]) from a daemon thread for the duration of the
    work, so only claims of genuinely dead workers ever age out.
    """

    def __init__(self, path: str, ttl_s: float):
        self.path = path
        self.interval_s = min(300.0, max(5.0, ttl_s / 4.0))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "ClaimHeartbeat":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            renew_claim_path(self.path)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
