"""Halo-chunked sliding-window inference: HDF5 embeddings -> per-frame CSV.

Port of ``cbas_tpu/engine/infer.py``. Frames are processed in chunks of
``chunk_frames`` with +-seq_len/2 halo reads, edge frames replicate-padded,
one probability row per frame.

- Each chunk is copied to the device once and the stride-1 windows are
  gathered there (``unfold``, a view), so no (B, T, D) window tensor crosses
  the host-device boundary.
- Chunks are padded to a doubling bucket of rows, and the window batch is
  fixed: the final partial batch re-reads overlapping windows at a clamped
  offset instead of changing shape.
- Probabilities (temperature softmax) are computed on the device.
- With a mesh (``parallel/mesh.py``) the window batch is padded to a
  multiple of the data axis (not of the device count), each chunk is copied
  to every data device, and each data shard runs its slice of the windows
  through its own copy of the head in its thread; the probabilities are
  gathered on the mesh's first device.

The file path (:meth:`InferenceSession.infer_h5`) imports ``h5py``, ``pandas``
and ``cbas_tpu``'s store, naming and metrics modules when it runs;
:meth:`InferenceSession.predict_frames` needs numpy and torch alone.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Callable, Optional

import numpy as np
import torch

from cbas_tpu_torch.core.config import InferenceConfig  # re-exported: callers import it here
from cbas_tpu_torch.engine.classifier import ClassifierBundle


def _window_program(bundle: ClassifierBundle, window_batch: int, device, mesh=None):
    """fn(chunk (M, D) on the device, offset) -> probs (window_batch, C).

    ``chunk`` holds seq_len-1 halo rows beyond the targets; window i covers
    rows [offset+i, offset+i+seq_len). With ``mesh``, ``chunk`` maps each
    data device to its copy, and data shard s computes windows
    [s * per, (s + 1) * per) of the batch on its device.
    """
    seq_len = bundle.seq_len

    def windows(chunk, start, n):
        rows = chunk[start: start + n + seq_len - 1]
        return rows.unfold(0, seq_len, 1).transpose(1, 2).float()  # (n, seq_len, D)

    if mesh is None:
        probs = bundle.probs_fn(device)

        @torch.inference_mode()
        def fn(chunk: torch.Tensor, offset: int) -> torch.Tensor:
            return probs(windows(chunk, offset, window_batch))

        return fn

    from cbas_tpu_torch.parallel.mesh import run_shards

    devices = list(mesh.grid()[:, 0])
    per = window_batch // len(devices)
    probs_on = {d: bundle.probs_fn(d) for d in dict.fromkeys(devices)}

    @torch.inference_mode()
    def fn(chunks: dict, offset: int) -> torch.Tensor:
        outs = run_shards(
            [lambda s=s, d=d: probs_on[d](windows(chunks[d], offset + s * per, per))
             for s, d in enumerate(devices)], devices)
        return torch.cat([o.to(devices[0]) for o in outs])

    return fn


class InferenceSession:
    """Reusable inference pipeline for one model bundle on one device, or
    data-parallel over a mesh's data axis (``mesh``; ``device`` is then the
    mesh's first device)."""

    def __init__(
        self,
        bundle: ClassifierBundle,
        config: Optional[InferenceConfig] = None,
        mesh=None,
        device="cuda",
    ):
        self.bundle = bundle
        self.cfg = config or InferenceConfig()
        self.mesh = mesh
        wb = self.cfg.window_batch
        if mesh is not None:
            from cbas_tpu_torch.parallel.mesh import check_devices, data_axis_size, pad_to_multiple

            check_devices(mesh)
            device = mesh.first_device
            wb = pad_to_multiple(wb, data_axis_size(mesh))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceSession(device='cuda') needs a CUDA device; none is visible")
        self._window_batch = wb
        self._program = _window_program(bundle, wb, self.device, mesh)

    def _upload(self, features: np.ndarray):
        """A chunk on the device, or on every data device of the mesh."""
        host = torch.from_numpy(np.ascontiguousarray(features))
        if self.mesh is None:
            return host.to(self.device)
        return {d: host.to(d) for d in dict.fromkeys(self.mesh.grid()[:, 0])}

    def _bucket_rows(self, n_targets: int) -> int:
        """Device rows for a chunk with ``n_targets`` target frames: the
        smallest doubling bucket of targets (window_batch, 2*window_batch, ...,
        chunk_frames) that fits, plus the 2*(seq_len//2) halo rows."""
        halo = 2 * (self.bundle.seq_len // 2)
        cap = max(self.cfg.chunk_frames, self._window_batch)
        bucket = self._window_batch
        while bucket < min(n_targets, cap):
            bucket = min(bucket * 2, cap)
        return bucket + halo

    def predict_frames(self, features: np.ndarray, pad_front: int, pad_back: int) -> np.ndarray:
        """Probabilities for every target frame of one halo-extended chunk.

        ``features``: (n_rows, D) embeddings covering the targets plus
        available halo; missing halo is synthesised by replicating edge rows
        ``pad_front``/``pad_back`` times.
        """
        h = self.bundle.seq_len // 2
        if pad_front:
            features = np.concatenate(
                [np.repeat(features[:1], pad_front, axis=0), features], axis=0
            )
        if pad_back:
            features = np.concatenate(
                [features, np.repeat(features[-1:], pad_back, axis=0)], axis=0
            )
        n_targets = features.shape[0] - 2 * h
        if n_targets <= 0:
            return np.zeros((0, len(self.bundle.behaviors)), np.float32)

        wb = self._window_batch
        fixed_rows = self._bucket_rows(n_targets)
        if features.shape[0] < fixed_rows:
            features = np.concatenate(
                [features,
                 np.repeat(features[-1:], fixed_rows - features.shape[0], axis=0)],
                axis=0,
            )
        chunk_dev = self._upload(features)

        out = np.empty((n_targets, len(self.bundle.behaviors)), np.float32)
        if n_targets <= wb:
            out[:] = self._program(chunk_dev, 0)[:n_targets].cpu().numpy()
            return out
        offset = 0
        while offset < n_targets:
            take = min(wb, n_targets - offset)
            # Clamp the final batch so it re-reads overlapping windows instead
            # of changing shape; keep only its trailing `take` rows.
            start = offset if take == wb else n_targets - wb
            probs = self._program(chunk_dev, start).cpu().numpy()
            out[offset: offset + take] = probs if take == wb else probs[-take:]
            offset += take
        return out

    def infer_h5(
        self,
        h5_path: str,
        output_csv: Optional[str] = None,
        progress_callback: Optional[Callable[[float], None]] = None,
        cancel_event=None,
    ) -> Optional[str]:
        """Run the full file and write ``*_<model>_outputs.csv``.

        ``cancel_event`` is polled per chunk; a cancelled file writes no CSV
        (the CSV's existence is the done-marker). The CSV is staged to a
        unique tmp name and renamed, so a crash never leaves a truncated one.
        """
        import h5py
        import pandas as pd

        from cbas_tpu_torch.core.hdf5_store import DATASET_NAME
        from cbas_tpu_torch.utils.metrics import INFER_FRAMES, INFER_WINDOWS, metrics
        from cbas_tpu_torch.utils.naming import outputs_csv_for_h5

        output_csv = output_csv or outputs_csv_for_h5(h5_path, self.bundle.name)
        h = self.bundle.seq_len // 2
        chunk = self.cfg.chunk_frames

        with h5py.File(h5_path, "r") as f:
            dset = f[DATASET_NAME]
            total = dset.shape[0]
            if total == 0:
                print(f"Warning: HDF5 file {h5_path} is empty.")
                return None

            all_probs = []
            for start in range(0, total, chunk):
                if cancel_event is not None and cancel_event.is_set():
                    return None
                end = min(start + chunk, total)
                read_start = max(0, start - h)
                read_end = min(total, end + h)
                features = dset[read_start:read_end]
                t0 = time.perf_counter()
                probs = self.predict_frames(
                    features,
                    pad_front=h - (start - read_start),
                    pad_back=h - (read_end - end),
                )
                metrics.add(INFER_WINDOWS, probs.shape[0], time.perf_counter() - t0)
                if probs.shape[0] != end - start:
                    raise RuntimeError(
                        f"predicted {probs.shape[0]} rows for frames [{start}, {end})"
                    )
                all_probs.append(probs)
                if progress_callback:
                    progress_callback(end / total * 100.0)

        probs = np.concatenate(all_probs, axis=0)
        metrics.add(INFER_FRAMES, total, 0.0)
        tmp = f"{output_csv}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            pd.DataFrame(probs, columns=self.bundle.behaviors).to_csv(tmp, index=False)
            os.replace(tmp, output_csv)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return output_csv


def infer_file(
    h5_path: str,
    bundle: ClassifierBundle,
    output_csv: Optional[str] = None,
    config: Optional[InferenceConfig] = None,
    progress_callback: Optional[Callable[[float], None]] = None,
    device="cuda",
) -> Optional[str]:
    """One-shot convenience wrapper (reference API: cbas.infer_file)."""
    return InferenceSession(bundle, config, device=device).infer_h5(
        h5_path, output_csv, progress_callback
    )
