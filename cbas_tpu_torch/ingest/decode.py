"""Host-side video decoding feeding the TPU pipeline.

Copy of ``cbas_tpu/ingest/decode.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Replaces the reference's decord dependency (backend/cbas.py:402,425) with two
backends behind one interface:

- :class:`NativeVideoReader` — our C++ libavcodec/libavformat decoder
  (ingest/native/), which decodes on dedicated threads and can emit the green
  plane directly (no RGB round-trip). Preferred when the extension is built.
- :class:`OpenCVVideoReader` — cv2.VideoCapture fallback, always available.

Both return uint8 RGB batches shaped (B, H, W, 3) so the device pipeline is
backend-agnostic.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


class VideoReader:
    """Interface: random-access chunked video decode."""

    path: str
    frame_count: int
    fps: float
    width: int
    height: int

    def read_batch(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start+count) as uint8 RGB (B, H, W, 3)."""
        raise NotImplementedError

    def read_green_batch(self, start: int, count: int) -> np.ndarray:
        """Decode the green plane only, (B, H, W) uint8 (default: slice RGB)."""
        return np.ascontiguousarray(self.read_batch(start, count)[:, :, :, 1])

    def close(self) -> None:  # pragma: no cover - trivial
        pass

    def __len__(self) -> int:
        return self.frame_count

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def iter_chunks(self, chunk_size: int) -> Iterator[Tuple[int, np.ndarray]]:
        for start in range(0, self.frame_count, chunk_size):
            n = min(chunk_size, self.frame_count - start)
            yield start, self.read_batch(start, n)


class OpenCVVideoReader(VideoReader):
    """Sequential-optimized cv2 decoder: seeks only on backward/far jumps."""

    def __init__(self, path: str):
        import cv2

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"Could not open video: {path}")
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 0.0
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._next_frame = 0
        self._lock = threading.Lock()
        if self.frame_count <= 0:
            # Some containers misreport; count by scanning (rare path).
            self.frame_count = self._count_by_scan()

    def _count_by_scan(self) -> int:
        n = 0
        while True:
            ok = self._cap.grab()
            if not ok:
                break
            n += 1
        self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
        self._next_frame = 0
        return n

    def read_batch(self, start: int, count: int) -> np.ndarray:
        with self._lock:
            gap = start - self._next_frame
            if 0 < gap <= 30:
                # Small forward jump: grab()-skip is frame-EXACT, where a
                # CAP_PROP_POS_FRAMES seek is keyframe-based and can land on
                # the wrong frame for long-GOP codecs (and costs a container
                # seek). Backward or far jumps still seek. Track the frames
                # ACTUALLY skipped: a failed grab mid-skip would otherwise
                # desynchronize the recorded position from the decoder and
                # silently mislabel every frame that follows.
                advanced = 0
                for _ in range(gap):
                    if not self._cap.grab():
                        break
                    advanced += 1
                self._next_frame += advanced
                if advanced < gap:
                    # `start` is unreachable (EOF/corruption mid-skip):
                    # decoding from the earlier position would return frames
                    # silently mislabeled as [start, ...).
                    return np.empty((0, self.height, self.width, 3), np.uint8)
            elif gap != 0:
                self._cap.set(self._cv2.CAP_PROP_POS_FRAMES, start)
                self._next_frame = start
            frames = np.empty((count, self.height, self.width, 3), np.uint8)
            got = 0
            for i in range(count):
                ok, bgr = self._cap.read()
                if not ok:
                    break
                # cv2 decodes BGR; flip to RGB so the green plane index matches
                # the reference's decord RGB layout (channel 1 either way, but
                # keep full RGB correct for thumbnails/labeling).
                frames[i] = bgr[:, :, ::-1]
                got += 1
            self._next_frame = start + got
            if got < count:
                frames = frames[:got]
            return frames

    def close(self) -> None:
        # Under the read lock: a concurrent close during read_batch would
        # free the cv2 capture mid-read (same contract as NativeVideoReader).
        with self._lock:
            self._cap.release()


def _native_available() -> bool:
    try:
        from cbas_tpu_torch.ingest.native import loader

        return loader.is_available()
    except Exception:
        return False


def open_video(path: str, backend: str = "auto") -> VideoReader:
    """Open a video with the best available decoder.

    ``backend``: ``auto`` (native when built, else OpenCV), ``native``
    (raise if unavailable), or ``opencv``. Anything else raises — a typo
    must not silently route everything through the slow path.
    """
    if backend not in ("auto", "native", "opencv"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if backend in ("auto", "native") and _native_available():
        from cbas_tpu_torch.ingest.native.loader import NativeVideoReader

        try:
            reader = NativeVideoReader(path)
            # Containers carrying neither nb_frames nor a duration report 0
            # frames from libav metadata; cv2's scan-count fallback still
            # counts them, so don't let "auto" silently skip a decodable
            # video as empty. Explicit "native" returns what native sees.
            if backend == "native" or reader.frame_count > 0:
                return reader
            reader.close()
        except Exception as e:
            if backend == "native":
                raise
            # Loud fallback: a systemically broken native extension would
            # otherwise silently decode everything through cv2 at a fraction
            # of the throughput with nothing in the logs to explain it.
            from cbas_tpu_torch.utils.logging import log_message

            log_message(
                f"Native decoder failed for {path} ({e}); using OpenCV fallback.",
                "WARN",
            )
    if backend == "native":
        raise RuntimeError("native decoder requested but not available")
    return OpenCVVideoReader(path)


def probe(path: str) -> dict:
    """Lightweight container probe (frame count, fps, geometry)."""
    with open_video(path) as r:
        return {
            "frame_count": r.frame_count,
            "fps": r.fps,
            "width": r.width,
            "height": r.height,
        }
