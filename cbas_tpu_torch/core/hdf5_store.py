"""The HDF5 embedding store: the durable checkpoint of the encode stage.

Copy of ``cbas_tpu/core/hdf5_store.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Compatibility contract with the reference (backend/cbas.py:409-442):

- dataset ``"cls"`` of shape ``(N, 768)``, dtype float16, chunks ``(8192, 768)``
- file attrs ``encoder_model_identifier`` and ``schema_version = "1.0"``
- written to ``<path>.tmp`` and atomically renamed on success

Files produced by either implementation are interchangeable.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, Iterator, Optional, Tuple

import h5py
import numpy as np

from cbas_tpu_torch.core.config import EMBED_DIM

SCHEMA_VERSION = "1.0"
DATASET_NAME = "cls"
DEFAULT_H5_CHUNK_ROWS = 8192


class EmbeddingWriter:
    """Streaming, atomic writer for a ``*_cls.h5`` embedding file.

    Appends fp16 embedding batches to a resizable dataset; the target path only
    appears once ``close(success=True)`` commits the temp file, so readers never
    observe a partial file.
    """

    def __init__(
        self,
        out_path: str,
        encoder_identifier: Optional[str] = None,
        embed_dim: int = EMBED_DIM,
        chunk_rows: int = DEFAULT_H5_CHUNK_ROWS,
    ):
        self.out_path = out_path
        # Unique staging name (same contract as infer.py's CSV tmp): two
        # concurrent encoders of one video — the app's EncodeWorker and a
        # fleet worker share no claim protocol — must not truncate each
        # other's live h5py handle through a shared '<out>.tmp', or the
        # first close(success=True) publishes interleaved pages as the
        # durable done-marker. Keeps the '.tmp' suffix (cleanup sweeps).
        self.tmp_path = f"{out_path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        self._h5 = h5py.File(self.tmp_path, "w")
        if encoder_identifier is not None:
            self._h5.attrs["encoder_model_identifier"] = encoder_identifier
        self._h5.attrs["schema_version"] = SCHEMA_VERSION
        self._dset = self._h5.create_dataset(
            DATASET_NAME,
            shape=(0, embed_dim),
            maxshape=(None, embed_dim),
            dtype="f2",
            chunks=(chunk_rows, embed_dim),
        )
        self._closed = False

    @property
    def rows_written(self) -> int:
        return self._dset.shape[0]

    def append(self, embeddings: np.ndarray) -> None:
        emb = np.asarray(embeddings)
        if emb.ndim != 2 or emb.shape[1] != self._dset.shape[1]:
            raise ValueError(f"expected (B, {self._dset.shape[1]}) embeddings, got {emb.shape}")
        n = self._dset.shape[0]
        self._dset.resize(n + emb.shape[0], axis=0)
        self._dset[n:] = emb.astype(np.float16, copy=False)
        self._h5.flush()

    def close(self, success: bool = True) -> Optional[str]:
        if self._closed:
            return self.out_path if os.path.exists(self.out_path) else None
        self._closed = True
        self._h5.close()
        if success:
            os.replace(self.tmp_path, self.out_path)
            return self.out_path
        if os.path.exists(self.tmp_path):
            try:
                os.remove(self.tmp_path)
            except OSError:
                pass
        return None

    def __enter__(self) -> "EmbeddingWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(success=exc_type is None)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def num_frames(h5_path: str) -> int:
    with h5py.File(h5_path, "r") as f:
        return int(f[DATASET_NAME].shape[0])


def encoder_stamp(h5_path: str) -> Optional[str]:
    """The encoder id the file was produced with, or None if unstamped."""
    try:
        with h5py.File(h5_path, "r") as f:
            v = f.attrs.get("encoder_model_identifier")
            return str(v) if v is not None else None
    except Exception:
        return None


def is_stamp_valid(h5_path: str, expected_encoder: str) -> bool:
    """True iff the file opens, is stamped, and matches the project encoder.

    Used by the project-load sweep to queue stale/corrupt files for re-encode
    (reference: backend/startup_page.py:92-117).
    """
    try:
        with h5py.File(h5_path, "r") as f:
            if DATASET_NAME not in f:
                return False
            stamp = f.attrs.get("encoder_model_identifier")
            if stamp is None:
                return False
            from cbas_tpu_torch.utils.naming import identities_equivalent

            # Compare machine-independent identities: stamps written against
            # a project-local encoder must survive the project moving hosts
            # AND fingerprint-algorithm upgrades (legacy stamps accepted).
            return identities_equivalent(str(stamp), expected_encoder)
    except Exception:
        return False


def read_all(h5_path: str) -> np.ndarray:
    with h5py.File(h5_path, "r") as f:
        return f[DATASET_NAME][:]


def read_slice(h5_path: str, start: int, end: int) -> np.ndarray:
    with h5py.File(h5_path, "r") as f:
        return f[DATASET_NAME][start:end]


class HandleCache:
    """Thread-safe cache of read-only H5 handles for hot window reads.

    The training data path slices thousands of tiny windows from a few files;
    reopening per read would dominate. The reference keeps a process-local
    handle dict with explicit cleanup after each training job
    (backend/cbas.py:56-84); this is the same idea with locking made explicit.
    """

    def __init__(self) -> None:
        self._handles: Dict[str, h5py.File] = {}
        self._lock = threading.Lock()

    def get(self, path: str) -> h5py.File:
        with self._lock:
            h = self._handles.get(path)
            if h is None:
                h = h5py.File(path, "r")
                self._handles[path] = h
            return h

    def read_window(self, path: str, start: int, end: int) -> np.ndarray:
        try:
            return self.get(path)[DATASET_NAME][start:end]
        except Exception:
            # The read runs outside the lock, so a concurrent close_all (end
            # of another job in this process) can close the handle mid-read.
            # Retrying with a fresh handle keeps the read correct instead of
            # letting gather() mask it as a corrupt window (label -1).
            with self._lock:
                h = self._handles.pop(path, None)
                if h is not None:
                    try:
                        h.close()
                    except Exception:
                        pass
            return self.get(path)[DATASET_NAME][start:end]

    def close_all(self) -> None:
        with self._lock:
            for h in self._handles.values():
                try:
                    h.close()
                except Exception:
                    pass
            self._handles.clear()

    def __len__(self) -> int:
        return len(self._handles)


# A module-level cache mirroring the reference's global handle dict; the
# training engine calls ``close_all`` at job end (backend/cbas.py:67-80).
global_handle_cache = HandleCache()


def iter_chunks(h5_path: str, chunk_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (start_row, chunk) pairs without loading the whole file."""
    with h5py.File(h5_path, "r") as f:
        dset = f[DATASET_NAME]
        n = dset.shape[0]
        for start in range(0, n, chunk_rows):
            yield start, dset[start : min(start + chunk_rows, n)]
