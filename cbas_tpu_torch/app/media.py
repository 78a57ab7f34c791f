"""Thumbnails and live preview (host-side media helpers).

Replaces the reference's one-frame ffmpeg grabs and MJPEG stdout scanning
(backend/record_page.py:23-286) with OpenCV capture: a single-frame JPEG
thumbnail for file/RTSP sources, and a push-based live preview loop with the
same 30s auto-timeout.
"""

from __future__ import annotations

import base64
import os
import threading
import time
from typing import Callable, Optional, Tuple

import cv2
import numpy as np


def _to_jpeg_b64(frame_bgr: np.ndarray, quality: int = 85) -> str:
    ok, buf = cv2.imencode(".jpg", frame_bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise ValueError("JPEG encode failed")
    return base64.b64encode(buf.tobytes()).decode("ascii")


def grab_frame(
    source: str,
    frame_index: int = 0,
    resize: Optional[Tuple[int, int]] = None,
    timeout_s: float = 10.0,
) -> Optional[str]:
    """One frame from a video file or RTSP URL as base64 JPEG (None on failure)."""
    cap = cv2.VideoCapture(source)
    try:
        if not cap.isOpened():
            return None
        if frame_index > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_index)
        # Retrying makes sense only for network streams (an RTSP camera may
        # need a moment to deliver the first frame); for local FILES a failed
        # read is permanent (EOF / corrupt / index past end) — retrying would
        # stall thumbnail rendering 10 s per bad file and pin pool workers.
        is_file = os.path.exists(str(source))
        deadline = time.monotonic() + (0.0 if is_file else timeout_s)
        while True:
            ok, frame = cap.read()
            if ok and frame is not None:
                if resize:
                    frame = cv2.resize(frame, resize, interpolation=cv2.INTER_AREA)
                return _to_jpeg_b64(frame)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)  # failed read: don't busy-spin a core for 10 s
    finally:
        cap.release()


def video_thumbnail(video_path: str, size: int = 256) -> Optional[str]:
    return grab_frame(video_path, frame_index=0, resize=(size, size))


def grab_frames_parallel(
    sources: "dict[str, tuple]",
    max_workers: int = 8,
    timeout_s: float = 10.0,
) -> "dict[str, Optional[str]]":
    """Thumbnail many sources concurrently: {name: (source, resize)} ->
    {name: b64 | None}.

    Many-camera rigs grab N RTSP streams at once; each grab blocks on network
    I/O for up to ``timeout_s``, so serial grabs scale O(N) in wall clock
    (the reference parallelized this with gevent/multiprocessing workers,
    record_page.py:23-152). A bounded thread pool keeps the worst case at
    O(N/max_workers) without per-request process spawns.
    """
    if not sources:
        return {}
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, (source, resize) = item
        try:
            return name, grab_frame(source, resize=resize, timeout_s=timeout_s)
        except Exception:
            return name, None

    with ThreadPoolExecutor(max_workers=min(max_workers, len(sources))) as pool:
        return dict(pool.map(one, sources.items()))


class LivePreview(threading.Thread):
    """Streams JPEG frames from an RTSP/camera source to a callback.

    Stops after ``timeout_s`` (the reference's 30s guard) or when ``stop()``
    is called; emits at most ``max_fps`` frames per second.
    """

    def __init__(
        self,
        source: str,
        on_frame: Callable[[str], None],
        timeout_s: float = 30.0,
        max_fps: float = 10.0,
        resize: Optional[Tuple[int, int]] = (256, 256),
        on_end: Optional[Callable[[], None]] = None,
    ):
        super().__init__(daemon=True, name="LivePreview")
        self.source = source
        self.on_frame = on_frame
        self.on_end = on_end
        self.timeout_s = timeout_s
        self.min_interval = 1.0 / max_fps if max_fps > 0 else 0.0
        self.resize = resize
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        cap = cv2.VideoCapture(self.source)
        try:
            if not cap.isOpened():
                return
            deadline = time.monotonic() + self.timeout_s
            last_emit = 0.0
            while not self._stop.is_set() and time.monotonic() < deadline:
                ok, frame = cap.read()
                if not ok:
                    break
                now = time.monotonic()
                if now - last_emit < self.min_interval:
                    continue
                last_emit = now
                if self.resize:
                    frame = cv2.resize(frame, self.resize, interpolation=cv2.INTER_AREA)
                try:
                    self.on_frame(_to_jpeg_b64(frame))
                except Exception:
                    break
        finally:
            cap.release()
            # Whatever ended the stream — timeout, stop(), unreachable camera,
            # emit failure — the UI must learn the preview is over (reference
            # emits end_live_preview so the button/canvas reset,
            # record_page.js:223-231).
            if self.on_end is not None:
                try:
                    self.on_end()
                except Exception:
                    pass
