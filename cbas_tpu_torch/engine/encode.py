"""Streamed video encoding: decode -> device ViT -> HDF5, pipelined.

Port of ``cbas_tpu/engine/encode.py``'s dense path. The host decode runs on a
prefetch thread ahead of the device: while the GPU encodes chunk N, the CPU
decodes chunk N+1 and chunk N-1's embeddings stream to the HDF5 writer. The
output file keeps the reference contract: "cls" (N, D) float16, chunks
(8192, D), encoder-stamped, atomic tmp+rename.

The host logic is the JAX package's; only the encoder type differs. The
reuse-gated encode (``EncodeConfig.reuse_threshold`` > 0) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

from cbas_tpu_torch.core.config import EncodeConfig
from cbas_tpu_torch.core.hdf5_store import EmbeddingWriter
from cbas_tpu_torch.ingest.decode import open_video
from cbas_tpu_torch.utils.logging import log_message
from cbas_tpu_torch.utils.metrics import (
    DECODE_FRAMES,
    ENCODE_FRAMES,
    ENCODE_FRAMES_COLD,
    H5_ROWS,
    metrics,
)
from cbas_tpu_torch.utils.naming import h5_path_for_video
from cbas_tpu_torch.models.encoder import FrameEncoder

_SENTINEL = object()


def _snap_chunk(cfg: EncodeConfig, video_len: int) -> EncodeConfig:
    """Snap the device batch down for short files: the video length rounded
    up to 32, so uniform segment sizes share one geometry and waste <= 31
    rows of padding."""
    if video_len >= cfg.chunk_frames:
        return cfg
    return dataclasses.replace(cfg, chunk_frames=max(32, -(-video_len // 32) * 32))


class EncodeStats:
    def __init__(self) -> None:
        self.frames = 0
        self.decode_s = 0.0
        self.device_s = 0.0
        self.wall_s = 0.0
        self.key_frames = 0     # frames actually encoded (reuse mode)
        self.reused_frames = 0  # frames that copied a key's embedding

    @property
    def fps(self) -> float:
        return self.frames / self.wall_s if self.wall_s else 0.0


def _start_decode_prefetch(reader, path, video_len, cfg, abort, cancel_event, stats):
    """Decode-prefetch thread over a bounded queue of at most
    ``prefetch_chunks`` decoded chunks. Returns ``(chunk_q, decode_err,
    thread)``; the consumer drains until the sentinel or sets ``abort``."""
    chunk_q: "queue.Queue" = queue.Queue(maxsize=max(1, cfg.prefetch_chunks))
    decode_err: list = []

    def decode_worker() -> None:
        try:
            for start in range(0, video_len, cfg.chunk_frames):
                if abort.is_set() or (
                    cancel_event is not None and cancel_event.is_set()
                ):
                    break
                n = min(cfg.chunk_frames, video_len - start)
                t = time.perf_counter()
                planes = reader.read_green_batch(start, n)
                metrics.add(DECODE_FRAMES, len(planes), time.perf_counter() - t)
                if stats is not None:
                    stats.decode_s += time.perf_counter() - t
                while not abort.is_set():
                    try:
                        chunk_q.put((start, planes), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if len(planes) < n:
                    # The usable video ends here: continuing would leave a
                    # gap and misalign later rows against frame numbers.
                    log_message(
                        f"Decode ended early at frame {start + len(planes)}"
                        f"/{video_len} for {path}; truncating embeddings.",
                        "WARN",
                    )
                    break
        except Exception as e:  # surfaced by the consumer
            decode_err.append(e)
        finally:
            # The sentinel must reach the consumer while it still listens.
            while not abort.is_set():
                try:
                    chunk_q.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    t_decode = threading.Thread(target=decode_worker, daemon=True, name="DecodePrefetch")
    t_decode.start()
    return chunk_q, decode_err, t_decode


def encode_file(
    encoder: FrameEncoder,
    path: str,
    progress_callback: Optional[Callable[[float], None]] = None,
    config: Optional[EncodeConfig] = None,
    cancel_event: Optional[threading.Event] = None,
    stats: Optional[EncodeStats] = None,
) -> Optional[str]:
    """Encode one video to ``<stem>_cls.h5``. Returns the output path, or None
    for empty videos. Raises on decode/encode errors (the temp file is
    cleaned up)."""
    cfg = config or EncodeConfig()
    if cfg.reuse_threshold > 0:
        raise NotImplementedError(
            "reuse-gated encode (reuse_threshold > 0) is not ported to "
            "cbas_tpu_torch yet (ROADMAP A.5); use reuse_threshold=0"
        )
    reader = open_video(path)
    abort = threading.Event()  # consumer-side failure -> stop the decode thread
    t_decode = None
    try:
        video_len = len(reader)
        if video_len == 0:
            print(f"Warning: video {path} contains no frames; skipping.")
            return None

        cfg = _snap_chunk(cfg, video_len)
        out_path = h5_path_for_video(path)
        t0 = time.perf_counter()

        chunk_q, decode_err, t_decode = _start_decode_prefetch(
            reader, path, video_len, cfg, abort, cancel_event, stats
        )

        writer = EmbeddingWriter(
            out_path,
            encoder_identifier=encoder.identifier,
            embed_dim=encoder.embed_dim,
            chunk_rows=cfg.h5_chunk_rows,
        )
        done = 0
        # One device batch stays in flight: while chunk N computes, chunk N+1
        # is uploaded and queued and chunk N-1's rows hit disk.
        in_flight = None  # (pending, chunk_end, was_warm, n_frames, dispatch_s)

        def await_in_flight() -> None:
            # The device wait is charged to the batch being awaited.
            nonlocal done, in_flight
            pending, chunk_end, was_warm, n_frames, dispatch_s = in_flight
            t = time.perf_counter()
            emb = encoder.to_host(pending)
            writer.append(emb)
            dt = time.perf_counter() - t
            metrics.add(H5_ROWS, emb.shape[0], dt)
            if stats is not None:
                stats.device_s += dt
            meter = ENCODE_FRAMES if was_warm else ENCODE_FRAMES_COLD
            metrics.add(meter, n_frames, dispatch_s + dt)
            done = chunk_end
            in_flight = None
            if progress_callback:
                progress_callback(done / video_len * 100.0)

        try:
            while True:
                item = chunk_q.get()
                if item is _SENTINEL:
                    if in_flight is not None:
                        await_in_flight()
                    break
                start, planes = item
                t_enc = time.perf_counter()
                pending = encoder.encode_planes_async(planes, batch=cfg.chunk_frames)
                was_warm = pending[2]
                dispatch_s = time.perf_counter() - t_enc
                if in_flight is not None:
                    await_in_flight()
                in_flight = (
                    pending, start + len(planes), was_warm, len(planes), dispatch_s
                )
            if decode_err:
                raise decode_err[0]
            if cancel_event is not None and cancel_event.is_set() and done < video_len:
                writer.close(success=False)
                return None
        except BaseException:
            writer.close(success=False)
            raise
        result = writer.close(success=True)
        if stats is not None:
            stats.frames += done
            stats.wall_s += time.perf_counter() - t0
        return result
    finally:
        # The decode thread may be mid-read; closing the decoder under it is
        # a use-after-free. Signal it, drain the queue so a blocked put
        # wakes, and join before releasing the reader.
        abort.set()
        if t_decode is not None:
            while t_decode.is_alive():
                try:
                    chunk_q.get_nowait()
                except queue.Empty:
                    pass
                t_decode.join(timeout=0.2)
        reader.close()
