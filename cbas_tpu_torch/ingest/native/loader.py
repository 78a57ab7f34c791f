"""ctypes bindings for the native libav decoder (see decoder.cpp).

Copy of ``cbas_tpu/ingest/native/loader.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from cbas_tpu_torch.ingest import decode

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            from cbas_tpu_torch.ingest.native.build import build

            lib = ctypes.CDLL(build())
        except Exception as e:
            _build_failed = True
            # Loud, once: this is the common breakage (missing g++ or libav
            # dev headers on a deploy host) and it permanently routes every
            # decode through the slow OpenCV path — without this line the
            # open_video() WARN never fires because _native_available()
            # already answered False.
            try:
                from cbas_tpu_torch.utils.logging import log_message

                log_message(
                    f"Native decoder unavailable ({type(e).__name__}: {e}); "
                    "all video decode falls back to OpenCV at reduced "
                    "throughput.", "WARN",
                )
            except Exception:
                pass
            return None

        lib.nd_open.restype = ctypes.c_void_p
        lib.nd_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.nd_close.argtypes = [ctypes.c_void_p]
        lib.nd_width.restype = ctypes.c_int
        lib.nd_width.argtypes = [ctypes.c_void_p]
        lib.nd_height.restype = ctypes.c_int
        lib.nd_height.argtypes = [ctypes.c_void_p]
        lib.nd_fps.restype = ctypes.c_double
        lib.nd_fps.argtypes = [ctypes.c_void_p]
        lib.nd_frame_count.restype = ctypes.c_int64
        lib.nd_frame_count.argtypes = [ctypes.c_void_p]
        lib.nd_read_rgb.restype = ctypes.c_int64
        lib.nd_read_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.nd_read_green.restype = ctypes.c_int64
        lib.nd_read_green.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


class NativeVideoReader(decode.VideoReader):
    """VideoReader backed by the C++ libav decoder.

    Thread-safety contract: reads serialize on ``self._lock`` (the native
    Decoder is single-stream), and ``close()`` takes the same lock so a
    concurrent close cannot free the AVFormatContext mid-decode. After
    close, reads raise IOError instead of passing NULL into C.
    """

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native decoder unavailable")
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.nd_open(path.encode(), err, len(err))
        if not self._h:
            raise IOError(f"native decoder: {err.value.decode()}: {path}")
        self.path = path
        self.width = lib.nd_width(self._h)
        self.height = lib.nd_height(self._h)
        self.fps = lib.nd_fps(self._h)
        self.frame_count = int(lib.nd_frame_count(self._h))
        self._lock = threading.Lock()
        self._scratch = np.empty(self.height * self.width * 3, np.uint8)

    def read_batch(self, start: int, count: int) -> np.ndarray:
        out = np.empty((count, self.height, self.width, 3), np.uint8)
        with self._lock:
            if not self._h:
                raise IOError(f"native decoder closed: {self.path}")
            got = self._lib.nd_read_rgb(
                self._h, start, count, out.ctypes.data_as(ctypes.c_void_p)
            )
        if got < 0:
            raise IOError(f"native decode error at frame {start} of {self.path}")
        return out[:got]

    def read_green_batch(self, start: int, count: int) -> np.ndarray:
        out = np.empty((count, self.height, self.width), np.uint8)
        with self._lock:
            if not self._h:
                raise IOError(f"native decoder closed: {self.path}")
            got = self._lib.nd_read_green(
                self._h, start, count,
                out.ctypes.data_as(ctypes.c_void_p),
                self._scratch.ctypes.data_as(ctypes.c_void_p),
            )
        if got < 0:
            raise IOError(f"native decode error at frame {start} of {self.path}")
        return out[:got]

    def close(self) -> None:
        # __del__ may run before __init__ finished (nd_open raised), so the
        # lock itself may be absent.
        lock = getattr(self, "_lock", None)
        if lock is None:
            return
        with lock:
            if getattr(self, "_h", None):
                self._lib.nd_close(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
