"""RTSP camera recording: ffmpeg HLS segmenter management + self-healing.

Keeps the reference's battle-tested ffmpeg recipe verbatim as data
(backend/cbas.py:751-831): rtsp-over-tcp input, fractional crop ->
aspect-preserving scale -> pad to square, libx264 ultrafast, HLS segmenter
emitting ``<camera>_%05d.mp4`` every ``segment_seconds`` with
program_date_time, stderr to a per-camera log. The recorder is a host-side
subsystem — no device code — and degrades gracefully when no ffmpeg binary is
present (recording disabled, everything else works).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import threading
import time
from subprocess import DEVNULL, PIPE, Popen
from typing import Callable, Dict, Optional, Tuple

from cbas_tpu_torch.core.config import CameraSettings
from cbas_tpu_torch.utils.logging import log_message


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def next_segment_number(dest_dir: str, camera_name: str) -> int:
    """First unused ``<camera>_%05d.mp4`` index in ``dest_dir``.

    A (re)start into a directory that already holds segments MUST continue
    the numbering: ffmpeg's HLS segmenter otherwise restarts at 00000 and
    overwrites previously recorded video (whose stamped H5s would keep
    validating against content that no longer exists).
    """
    pat = re.compile(re.escape(camera_name) + r"_(\d+)\.mp4$")
    highest = -1
    try:
        for f in os.listdir(dest_dir):
            m = pat.fullmatch(f)
            if m:
                highest = max(highest, int(m.group(1)))
    except OSError:
        pass
    return highest + 1


def build_record_command(
    cam: CameraSettings, dest_pattern: str, playlist_file: str,
    start_number: int = 0,
) -> list:
    """The recording command line (reference: backend/cbas.py:768-784)."""
    filter_string = (
        f"crop=iw*{cam.crop_width}:ih*{cam.crop_height}:"
        f"iw*{cam.crop_left_x}:ih*{cam.crop_top_y},"
        f"scale={cam.resolution}:{cam.resolution}:force_original_aspect_ratio=decrease,"
        f"pad={cam.resolution}:{cam.resolution}:(ow-iw)/2:(oh-ih)/2"
    )
    return [
        "ffmpeg", "-hide_banner", "-loglevel", "warning",
        "-rtsp_transport", "tcp", "-timeout", "15000000",
        "-stream_loop", "-1",
        "-i", cam.record_url,
        "-vf", filter_string, "-r", str(cam.framerate), "-an", "-c:v", "libx264",
        "-preset", "ultrafast", "-pix_fmt", "yuv420p", "-g", str(cam.framerate * 2),
        "-sc_threshold", "0", "-f", "hls", "-hls_time", str(cam.segment_seconds),
        "-hls_list_size", "0", "-hls_flags", "delete_segments+program_date_time",
        "-start_number", str(start_number),
        "-hls_segment_filename", dest_pattern, "-y", playlist_file,
    ]


class RecordingManager:
    """Owns the active ffmpeg recording process per camera."""

    RESTART_COOLDOWN_S = 60.0

    def __init__(self, recordings_dir: str, on_final_segment: Optional[Callable[[str], None]] = None):
        self.recordings_dir = recordings_dir
        self.on_final_segment = on_final_segment
        # name -> (process, start_time, session_name)
        self.active: Dict[str, Tuple[Popen, float, str]] = {}
        self.current_session: Optional[str] = None
        self._last_restart: Dict[str, float] = {}
        # Cameras whose dead recording couldn't be restarted yet (cooldown,
        # missing config, failed start): retried every heal pass rather than
        # silently abandoned.
        self._pending_restart: Dict[str, str] = {}  # name -> session
        self._lock = threading.Lock()

    def camera_dir(self, session: str, camera: str) -> str:
        return os.path.join(self.recordings_dir, session, camera)

    def snapshot_active(self) -> Dict[str, float]:
        """name -> recording start epoch, copied under the lock (RPC threads
        iterate this while start/stop mutate the dict)."""
        with self._lock:
            return {name: start for name, (_, start, _) in self.active.items()}

    def start(self, cam: CameraSettings, session_name: str) -> bool:
        if not ffmpeg_available():
            log_message("ffmpeg binary not found; recording is unavailable.", "ERROR")
            return False
        with self._lock:
            if cam.name in self.active:
                log_message(f"[{cam.name}] is already recording.", "WARN")
                return False
            self.current_session = session_name
            dest_dir = self.camera_dir(session_name, cam.name)
            os.makedirs(dest_dir, exist_ok=True)
            playlist = os.path.join(dest_dir, f"{cam.name}_playlist.m3u8")
            log_path = os.path.join(dest_dir, f"{cam.name}_ffmpeg_err.log")
            pattern = os.path.join(dest_dir, f"{cam.name}_%05d.mp4")
            cmd = build_record_command(
                cam, pattern, playlist,
                start_number=next_segment_number(dest_dir, cam.name),
            )
            try:
                log_file = open(log_path, "a")
                proc = Popen(cmd, stdin=PIPE, stdout=DEVNULL, stderr=log_file)
                self.active[cam.name] = (proc, time.time(), session_name)
                log_message(f"Recording started for '{cam.name}' (session '{session_name}').")
                return True
            except Exception as e:
                log_message(f"Failed to start ffmpeg for {cam.name}: {e}", "ERROR")
                return False

    def stop(self, camera_name: str) -> bool:
        with self._lock:
            entry = self.active.pop(camera_name, None)
            self._pending_restart.pop(camera_name, None)  # user-intent stop
        if entry is None:
            return False
        proc, _, session = entry
        try:
            if proc.stdin:
                proc.stdin.write(b"q")
                proc.stdin.flush()
                proc.stdin.close()
            proc.wait(timeout=5)
        except Exception as e:
            log_message(f"Error stopping recorder for {camera_name}: {e}; killing.", "WARN")
            proc.kill()
            try:
                proc.wait(timeout=5)  # reap — kill() alone leaves a zombie
            except Exception:
                pass

        # Queue the final (still-unwatched) segment for encoding
        # (reference: backend/cbas.py:814-828).
        try:
            cam_dir = self.camera_dir(session, camera_name)
            if os.path.isdir(cam_dir) and self.on_final_segment:
                from cbas_tpu_torch.ingest.standardize import is_aug_video
                from cbas_tpu_torch.utils.naming import is_staging_artifact

                # Same filter as every other scanner: a '*.tmp.mp4' staging
                # file (augmentation/import mid-write) or an '_aug' sibling
                # can be the newest mtime in the dir and must never be
                # queued as the recording's final segment.
                segments = [
                    os.path.join(cam_dir, f)
                    for f in os.listdir(cam_dir)
                    if f.endswith(".mp4")
                    and not is_staging_artifact(f)
                    and not is_aug_video(f)
                ]
                if segments:
                    latest = max(segments, key=os.path.getmtime)
                    self.on_final_segment(latest)
        except Exception as e:
            log_message(f"Could not queue final segment for {camera_name}: {e}", "ERROR")
        return True

    def stop_all(self) -> None:
        # Pending restarts are user-intent stops too: without clearing them,
        # an in-flight check_and_heal pass could resurrect a dead camera's
        # ffmpeg AFTER a stop-everything (its pending entry would make
        # still_wanted true).
        with self._lock:
            self._pending_restart.clear()
        for name in list(self.active.keys()):
            self.stop(name)

    def check_and_heal(self, cameras: Dict[str, CameraSettings]) -> None:
        """Restart recordings whose ffmpeg process died, with a per-camera
        cooldown (reference: backend/workthreads.py:139-176)."""
        with self._lock:
            dead = [
                (name, session)
                for name, (proc, _, session) in self.active.items()
                if proc.poll() is not None
            ]
            # Move dead cameras to pending INSIDE this critical section: a
            # stop() arriving after the lock releases then pops the pending
            # entry too, so a user-stopped camera is never resurrected.
            for name, session in dead:
                del self.active[name]
                self._pending_restart[name] = session
        for name, _ in dead:
            log_message(f"Recording process for '{name}' terminated unexpectedly.", "WARN")
        # Retry every camera awaiting a restart — skipped ones stay pending so
        # the monitor keeps trying after the cooldown instead of abandoning
        # the camera the moment crashes become frequent.
        with self._lock:
            pending = dict(self._pending_restart)
        for name, session in pending.items():
            now = time.time()
            if now - self._last_restart.get(name, 0.0) <= self.RESTART_COOLDOWN_S:
                log_message(
                    f"Deferring restart for '{name}' (within {self.RESTART_COOLDOWN_S:.0f}s cooldown).",
                    "WARN",
                )
                continue
            cam = cameras.get(name)
            if cam is None:
                log_message(f"Cannot restart '{name}': camera config not found.", "ERROR")
                continue
            # Arm the cooldown on the ATTEMPT, not only on success: a
            # persistently failing start (ffmpeg gone, bad config) would
            # otherwise be retried — with an ERROR log — every 5 s monitor
            # pass instead of every RESTART_COOLDOWN_S.
            self._last_restart[name] = now
            if self.start(cam, session):
                with self._lock:
                    still_wanted = self._pending_restart.pop(name, None) is not None
                if not still_wanted:
                    # stop() raced the restart: honor the user's intent.
                    self.stop(name)
                    continue
                log_message(f"Successfully restarted recording for '{name}'.")


def run_monitor(
    manager: RecordingManager,
    cameras_provider: Callable[[], Dict[str, CameraSettings]],
    stop_event: threading.Event,
    interval_s: float = 5.0,
) -> None:
    """Self-heal monitor loop body (daemon thread target)."""
    while not stop_event.is_set():
        stop_event.wait(interval_s)
        if stop_event.is_set():
            break
        try:
            if manager.active or manager._pending_restart:
                manager.check_and_heal(cameras_provider())
        except Exception as e:
            log_message(f"Recording monitor error: {e}", "ERROR")
