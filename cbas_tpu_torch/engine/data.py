"""Training data: window sources, the device window store, balanced sampling.

Port of ``cbas_tpu/engine/data.py``. Training examples are manifest entries
``(h5_path, center_frame, label_index)``; windows are sliced on demand.

- :func:`build_manifest` reads files and is the JAX package's own, imported
  when called.
- :class:`WindowSource` gathers (B, T, D) float32 windows through a cache.
  ``h5py`` and ``cbas_tpu.core.hdf5_store`` are imported only where a file is
  opened: any object whose ``get(path)["cls"]`` slices like a dataset and
  that has ``read_window`` serves in-memory embeddings with neither.
- :class:`DeviceWindowStore` stacks every referenced row into one (R, D)
  tensor on a device; a batch is its centre rows, and the train step gathers
  the windows on the device.
- The samplers and the small helpers are numpy copies of the originals, held
  equal to them by a test (same seeds, same index streams).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

ManifestEntry = Tuple[str, int, int]  # (h5_path, center_frame, label_index)
Instance = Dict[str, object]

DATASET_NAME = "cls"  # cbas_tpu.core.hdf5_store.DATASET_NAME


def build_manifest(project_root, instances, seq_len, behaviors, progress_callback=None):
    """One manifest entry per labeled frame with a full in-bounds window
    (``cbas_tpu.engine.data.build_manifest``; reads the HDF5 files)."""
    from cbas_tpu.engine.data import build_manifest as _build

    return _build(project_root, instances, seq_len, behaviors, progress_callback)


def _preload_budget_bytes() -> int:
    """RAM the training-set preload may claim: CBAS_TRAIN_RAM_BUDGET bytes if
    set, else half of currently-available physical memory (or 8 GB when the
    platform can't report it)."""
    env = os.environ.get("CBAS_TRAIN_RAM_BUDGET")
    if env:
        return int(env)
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2
    except (ValueError, OSError, AttributeError):
        return 8 * 1024**3


class WindowSource:
    """Gathers window batches for manifest indices: (B, seq_len, D) float32.

    With ``preload=True`` each referenced file's labeled span is pulled into
    RAM once (stored dtype) and window gathers become memcpy. ``cache`` is
    the shared HDF5 handle cache when None.
    """

    def __init__(
        self,
        manifest: Sequence[ManifestEntry],
        seq_len: int,
        cache=None,
        preload: bool = False,
    ):
        self.manifest = list(manifest)
        self.seq_len = seq_len
        self.half = seq_len // 2
        if cache is None:
            from cbas_tpu.core.hdf5_store import global_handle_cache as cache
        self.cache = cache
        self._dim: Optional[int] = None
        # path -> (rows array, first-row offset); only the referenced span of
        # each file is resident, not the whole recording.
        self._ram: Optional[Dict[str, Tuple[np.ndarray, int]]] = None
        if preload:
            self.preload_all()

    def preload_all(self) -> None:
        """Pull each referenced file's labeled span into RAM (stored dtype).

        Loads only [min_center - half, max_center + half] per file. If the
        projected total exceeds the RAM budget (CBAS_TRAIN_RAM_BUDGET bytes,
        default half of available memory), stays on the lazy per-window path.
        """
        spans: Dict[str, Tuple[int, int]] = {}
        for path, center, _ in self.manifest:
            lo, hi = spans.get(path, (center, center))
            spans[path] = (min(lo, center), max(hi, center))

        total = 0
        plans: Dict[str, Tuple[int, int]] = {}
        for path, (lo, hi) in spans.items():
            ds = self.cache.get(path)[DATASET_NAME]
            start = max(0, lo - self.half)
            stop = min(ds.shape[0], hi + self.half + 1)
            plans[path] = (start, stop)
            total += (stop - start) * ds.shape[1] * ds.dtype.itemsize

        budget = _preload_budget_bytes()
        if total > budget:
            from cbas_tpu.utils.logging import log_message

            log_message(
                f"Training-set preload would need {total / 1e9:.1f} GB "
                f"(budget {budget / 1e9:.1f} GB); using lazy HDF5 reads.",
                "WARN",
            )
            self._ram = None
            return

        ram: Dict[str, Tuple[np.ndarray, int]] = {}
        for path, (start, stop) in plans.items():
            ram[path] = (self.cache.get(path)[DATASET_NAME][start:stop], start)
        self._ram = ram

    def __len__(self) -> int:
        return len(self.manifest)

    @property
    def embed_dim(self) -> int:
        if self._dim is None:
            if not self.manifest:
                raise ValueError("empty manifest")
            path = self.manifest[0][0]
            if self._ram is not None:
                self._dim = int(self._ram[path][0].shape[1])
            else:
                self._dim = int(self.cache.get(path)[DATASET_NAME].shape[1])
        return self._dim

    def labels(self) -> np.ndarray:
        return np.array([e[2] for e in self.manifest], np.int32)

    def gather(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (windows (B, T, D) float32, labels (B,) int32).

        Corrupt/short reads yield zero windows with label -1, which the
        training loss masks out.
        """
        B = len(indices)
        out = np.zeros((B, self.seq_len, self.embed_dim), np.float32)
        labels = np.full((B,), -1, np.int32)
        for row, idx in enumerate(indices):
            h5_path, center, label = self.manifest[idx]
            try:
                if self._ram is not None:
                    rows, off = self._ram[h5_path]
                    window = rows[center - self.half - off : center + self.half + 1 - off]
                else:
                    window = self.cache.read_window(
                        h5_path, center - self.half, center + self.half + 1
                    )
                if window.shape[0] != self.seq_len:
                    continue
                out[row] = window.astype(np.float32)
                labels[row] = label
            except Exception as e:
                print(f"WARNING: could not read window from {h5_path}: {e}")
        return out, labels


class DeviceWindowStore:
    """All referenced embeddings stacked into one tensor on ``device``.

    The rows of every file in the manifest live on the device once, in their
    stored dtype (fp16 for the HDF5 store); a window batch is described by
    its centre-row indices (a few KB host-to-device per step) and gathered
    inside the train step. ``ram`` is a ``WindowSource`` preload to reuse
    instead of reading the files again.
    """

    def __init__(
        self,
        manifest: Sequence[ManifestEntry],
        seq_len: int,
        device,
        ram: Optional[Dict[str, Tuple[np.ndarray, int]]] = None,
    ):
        self.seq_len = seq_len
        self.half = seq_len // 2
        paths = sorted({e[0] for e in manifest})
        offsets: Dict[str, int] = {}
        rows = []
        total = 0
        for p in paths:
            if ram is not None and p in ram:
                # The preload holds only the referenced span of each file,
                # starting at row span_off.
                arr, span_off = ram[p]
            else:
                import h5py

                with h5py.File(p, "r") as f:
                    arr = f[DATASET_NAME][:]
                span_off = 0
            # File-row c lands at stacked row (total + c - span_off); every
            # manifest window [c-half, c+half] lies inside the span by
            # construction (preload_all widens by half on both sides).
            offsets[p] = total - span_off
            total += arr.shape[0]
            rows.append(arr)
        stacked = np.concatenate(rows, axis=0) if rows else np.zeros((0, 1), np.float16)
        self.features = torch.from_numpy(stacked).to(device)
        self.centers = np.array([offsets[p] + c for p, c, _ in manifest], np.int32)
        self.labels = np.array([l for _, _, l in manifest], np.int32)
        self.embed_dim = int(stacked.shape[1])
        self.nbytes = stacked.nbytes

    def batch_indices(self, indices: np.ndarray, batch_size: int):
        """(centers (B,), labels (B,)) padded with label -1 (static shapes)."""
        n_valid = len(indices)
        # Padded rows point at a harmless in-bounds window; label -1 masks them.
        centers = np.full(batch_size, self.half, np.int32)
        labels = np.full(batch_size, -1, np.int32)
        centers[:n_valid] = self.centers[indices]
        labels[:n_valid] = self.labels[indices]
        return centers, labels


class BalancedSampler:
    """Class-balanced oversampling index stream: each epoch draws the same
    number of rows from every class present (uniform within a class), padded
    to a multiple of the classes, shuffled."""

    def __init__(self, manifest: Sequence[ManifestEntry], num_behaviors: int, seed: int = 0):
        buckets: Dict[int, List[int]] = defaultdict(list)
        for i, (_, _, label) in enumerate(manifest):
            if 0 <= label < num_behaviors:
                buckets[label].append(i)
        self.buckets = [np.array(v, np.int64) for v in buckets.values() if v]
        self.total = len(manifest)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n_avail = len(self.buckets)
        if n_avail == 0:
            return 0
        return self.total + (n_avail - self.total % n_avail) % n_avail

    def epoch_indices(self) -> np.ndarray:
        n_avail = len(self.buckets)
        if n_avail == 0:
            return np.array([], np.int64)
        n = len(self)
        per_class = n // n_avail
        draws = [
            bucket[self._rng.integers(0, len(bucket), per_class)]
            for bucket in self.buckets
        ]
        idx = np.concatenate(draws)
        self._rng.shuffle(idx)
        return idx


class SequentialSampler:
    """Plain pass over the manifest, optionally shuffled per epoch."""

    def __init__(self, n: int, shuffle: bool = False, seed: int = 0):
        self.n = n
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n

    def epoch_indices(self) -> np.ndarray:
        idx = np.arange(self.n, dtype=np.int64)
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx


def iter_batches(
    source: WindowSource,
    sampler,
    batch_size: int,
    pad_final: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (windows, labels, n_valid) fixed-shape batches.

    The final partial batch is padded by repeating row 0 with labels set to
    -1 past ``n_valid``, so every batch has one shape.
    """
    indices = sampler.epoch_indices()
    for start in range(0, len(indices), batch_size):
        chunk = indices[start : start + batch_size]
        n_valid = len(chunk)
        if n_valid < batch_size and pad_final:
            pad = np.zeros(batch_size - n_valid, np.int64)
            chunk = np.concatenate([chunk, pad])
        x, y = source.gather(chunk)
        if n_valid < len(chunk):
            y[n_valid:] = -1
        yield x, y, n_valid


def compute_class_weights(
    train_insts: Sequence[Instance],
    behaviors: Sequence[str],
    epsilon: float = 1e-6,
) -> np.ndarray:
    """Inverse-frequency class weights normalized to sum to len(behaviors);
    labels are stripped as ``build_manifest`` strips them."""
    counts = {b: 0 for b in behaviors}
    for inst in train_insts:
        lbl = str(inst.get("label", "")).strip()
        if lbl in counts:
            counts[lbl] += 1
    raw = np.array(
        [1.0 / counts[b] if counts[b] else 1.0 / epsilon for b in behaviors],
        np.float32,
    )
    return raw / raw.sum() * len(behaviors)


def instances_for_subjects(
    instances: Sequence[Instance], subjects: Sequence[str]
) -> List[Instance]:
    from cbas_tpu.core.splits import subject_of

    subject_set = set(subjects)
    return [i for i in instances if subject_of(i) in subject_set]
