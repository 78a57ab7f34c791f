"""Video import, standardization, and augmentation (host-side transforms).

The reference shells out to ffmpeg for these (backend/label_train_page.py:124-213,
backend/workthreads.py:178-265). Here the same transforms run through OpenCV's
codec bindings so they work without an ffmpeg binary; when one is present the
equivalent ffmpeg commands are used for speed (identical filter semantics).

Standardization target (reference: label_train_page.py:143-181): fps=10,
square ``resolution`` x ``resolution``, either stretched or aspect-preserving
padded. Augmentation (workthreads.py:201): horizontal flip, brightness +0.03,
contrast x1.1, gaussian blur sigma 0.2 — producing resumable ``*_aug.mp4``
siblings.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from cbas_tpu_torch.ingest.decode import open_video
from cbas_tpu_torch.utils.naming import STAGING_SUFFIX
from cbas_tpu_torch.utils.logging import log_message

AUG_FILTER_CHAIN = "hflip,eq=brightness=0.03:contrast=1.1,gblur=sigma=0.2"


def _writer(path: str, fps: float, size: Tuple[int, int]) -> cv2.VideoWriter:
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    if not w.isOpened():
        raise IOError(f"Could not open video writer for {path}")
    return w


def crop_fractional(frame: np.ndarray, crop: Tuple[float, float, float, float]) -> np.ndarray:
    """crop = (left_x, top_y, width, height) as fractions of the frame."""
    h, w = frame.shape[:2]
    x0 = int(round(crop[0] * w))
    y0 = int(round(crop[1] * h))
    x1 = min(w, x0 + max(1, int(round(crop[2] * w))))
    y1 = min(h, y0 + max(1, int(round(crop[3] * h))))
    return frame[y0:y1, x0:x1]


def fit_square(frame: np.ndarray, resolution: int, stretch: bool) -> np.ndarray:
    """Resize to resolution x resolution, stretched or aspect-padded (centered)."""
    if stretch:
        return cv2.resize(frame, (resolution, resolution), interpolation=cv2.INTER_AREA)
    h, w = frame.shape[:2]
    scale = min(resolution / w, resolution / h)
    nw, nh = max(1, int(round(w * scale))), max(1, int(round(h * scale)))
    resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_AREA)
    out = np.zeros((resolution, resolution, 3), frame.dtype)
    y0 = (resolution - nh) // 2
    x0 = (resolution - nw) // 2
    out[y0 : y0 + nh, x0 : x0 + nw] = resized
    return out


def standardize_video(
    src_path: str,
    dst_path: str,
    fps: float = 10.0,
    resolution: int = 256,
    stretch: bool = False,
    crop: Optional[Tuple[float, float, float, float]] = None,
    progress_callback: Optional[Callable[[float], None]] = None,
) -> str:
    """Re-time to ``fps`` and re-frame to a square; frame selection uses
    timestamp rounding (the same frames ffmpeg's fps filter picks)."""
    tmp_path = dst_path + STAGING_SUFFIX  # excluded by every scanner/watcher
    written = 0
    try:
        with open_video(src_path) as reader:
            src_fps = reader.fps or fps
            n = reader.frame_count
            duration = n / src_fps if src_fps > 0 else 0
            out_frames = max(1, int(round(duration * fps))) if duration else n
            writer = _writer(tmp_path, fps, (resolution, resolution))
            try:
                # Map each output timestamp to the nearest source frame.
                src_indices = np.minimum(
                    (np.arange(out_frames) * (src_fps / fps)).round().astype(int), n - 1
                )
                # Bound each read by SOURCE frames, not output frames: a
                # fixed output chunk spans src_fps/fps times more source
                # frames (64 outputs at 10 fps from a 4K/60fps phone video
                # would pre-allocate a multi-GB batch and MemoryError).
                max_src_span = 256
                pos = 0
                truncated = False
                while pos < out_frames and not truncated:
                    lo = int(src_indices[pos])
                    end = int(
                        np.searchsorted(src_indices, lo + max_src_span, side="left")
                    )
                    take = src_indices[pos:end]
                    hi = int(take[-1]) + 1
                    batch = reader.read_batch(lo, hi - lo)
                    avail_end = lo + batch.shape[0]
                    for idx in take:
                        if idx >= avail_end:
                            # The decoder returned fewer frames than the
                            # container promised — stop, don't replicate.
                            truncated = True
                            break
                        frame = batch[idx - lo]
                        if crop is not None:
                            frame = crop_fractional(frame, crop)
                        frame = fit_square(frame, resolution, stretch)
                        writer.write(frame[:, :, ::-1])  # RGB -> BGR for cv2
                        written += 1
                        pos += 1
                    if progress_callback:
                        progress_callback(min(100.0, pos / out_frames * 100.0))
            finally:
                writer.release()
        # Container metadata routinely overstates decodable frames by a few
        # (VFR, slightly truncated mp4/avi) — hard-failing on ANY shortfall
        # made such videos permanently unimportable, so a small tail
        # tolerance commits the shorter output (the reference's streaming
        # ffmpeg does the same). A LARGE shortfall is a mid-video decoder
        # death: refuse to commit, the partial file would silently replace
        # the recording downstream.
        tail_tolerance = max(5, out_frames // 50)  # 2% or 5 frames
        if written < out_frames - tail_tolerance:
            raise IOError(
                f"decode stopped early: wrote {written}/{out_frames} frames of "
                f"{src_path} — refusing to commit a truncated standardization"
            )
        if written < out_frames:
            log_message(
                f"Decode ended {out_frames - written} frame(s) short of the "
                f"container metadata for {src_path}; committing the "
                f"{written}-frame standardization.",
                "WARN",
            )
    except BaseException:
        if os.path.exists(tmp_path):
            try:
                os.remove(tmp_path)
            except OSError:
                pass
        raise
    os.replace(tmp_path, dst_path)
    return dst_path


def import_videos(
    sources: Sequence[str],
    dest_dir: str,
    standardize: bool = True,
    fps: float = 10.0,
    resolution: int = 256,
    stretch: bool = False,
    crop: Optional[Tuple[float, float, float, float]] = None,
    progress_callback: Optional[Callable[[float, str], None]] = None,
    on_imported: Optional[Callable[[str], None]] = None,
) -> List[str]:
    """Import external videos into a recording folder, optionally standardized
    (reference: backend/label_train_page.py:124-213). Returns imported paths.

    ``on_imported`` fires as EACH file lands (not after the batch): the
    caller must mark it handled with the watcher immediately, or a large
    multi-file import lets the watcher promote early-finished files
    mid-batch and encode them twice.
    """
    os.makedirs(dest_dir, exist_ok=True)
    out_paths: List[str] = []
    used_names: set = set()
    for i, src in enumerate(sources):
        name = os.path.basename(src)
        # Two sources can share a basename (e.g. /camA/video1.mp4 and
        # /camB/video1.mp4): uniquify within this import so the second does
        # not silently clobber the first in dest_dir.
        if name in used_names:
            stem, ext = os.path.splitext(name)
            k = 1
            while f"{stem}_{k}{ext}" in used_names:
                k += 1
            name = f"{stem}_{k}{ext}"
        used_names.add(name)
        dst = os.path.join(dest_dir, name)
        if progress_callback:
            progress_callback(i / max(1, len(sources)) * 100.0, name)
        try:
            if standardize or crop is not None:
                standardize_video(
                    src, dst, fps=fps, resolution=resolution, stretch=stretch, crop=crop
                )
            else:
                shutil.copy2(src, dst)
            out_paths.append(dst)
            if on_imported:
                on_imported(dst)
        except Exception as e:
            log_message(f"Import failed for '{src}': {e}", "ERROR")
    if progress_callback:
        progress_callback(100.0, "done")
    return out_paths


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------

def augment_frame(frame_bgr: np.ndarray) -> np.ndarray:
    """hflip + brightness +0.03 + contrast x1.1 + gaussian blur sigma 0.2.

    Approximates ffmpeg's ``eq`` filter, which operates on the LUMA plane
    (chroma untouched): brightness/contrast are applied to Y in YCrCb space
    so the fallback's color rendition tracks the ffmpeg path (a per-RGB eq
    visibly shifts saturated colors). Residual difference: ffmpeg works in
    limited-range YUV; this uses full-range YCrCb — within codec
    quantization for these mild parameters.
    """
    f = cv2.cvtColor(frame_bgr[:, ::-1, :], cv2.COLOR_BGR2YCrCb).astype(np.float32)
    y = f[:, :, 0] / 255.0
    f[:, :, 0] = np.clip((y - 0.5) * 1.1 + 0.5 + 0.03, 0.0, 1.0) * 255.0
    out = cv2.cvtColor(f.astype(np.uint8), cv2.COLOR_YCrCb2BGR).astype(np.float32)
    out = cv2.GaussianBlur(out, (0, 0), sigmaX=0.2)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def aug_path_for(video_path: str) -> str:
    stem, _ = os.path.splitext(video_path)
    return f"{stem}_aug.mp4"


def is_aug_video(path: str) -> bool:
    return os.path.splitext(os.path.basename(path))[0].endswith("_aug")


def augment_video(src_path: str, dst_path: Optional[str] = None) -> str:
    """Create the augmented sibling of one video (idempotent)."""
    dst_path = dst_path or aug_path_for(src_path)
    if os.path.exists(dst_path):
        return dst_path
    tmp = dst_path + STAGING_SUFFIX  # excluded by every scanner/watcher
    try:
        if shutil.which("ffmpeg"):
            subprocess.run(
                ["ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
                 "-i", src_path, "-vf", AUG_FILTER_CHAIN, "-an", tmp],
                check=True,
            )
            os.replace(tmp, dst_path)
            return dst_path
        with open_video(src_path) as reader:
            fps = reader.fps or 10.0
            writer = _writer(tmp, fps, (reader.width, reader.height))
            try:
                for _, batch in reader.iter_chunks(64):
                    for frame in batch:
                        writer.write(augment_frame(frame[:, :, ::-1]))
            finally:
                writer.release()
        os.replace(tmp, dst_path)
        return dst_path
    except BaseException:
        # The tmp name ends in .mp4 (muxers key on the extension), so an
        # orphan would match video globs and feed a broken partial file into
        # the watcher/encode pipeline — always clean it up on failure.
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def augment_dataset(
    project,
    source_dataset_name: str,
    new_dataset_name: str,
    progress_callback: Optional[Callable[[float, str], None]] = None,
):
    """Create an augmented copy of a dataset: ``*_aug.mp4`` siblings for every
    labeled video plus remapped label instances, resumable and idempotent
    (reference: backend/workthreads.py:178-265)."""
    source = project.datasets.get(source_dataset_name)
    if source is None:
        raise ValueError(f"Source dataset '{source_dataset_name}' not found.")
    if new_dataset_name in project.datasets:
        log_message(f"Resuming augmentation into existing dataset '{new_dataset_name}'.")
        new_ds = project.datasets[new_dataset_name]
    else:
        new_ds = project.create_dataset(
            new_dataset_name,
            source.config.get("behaviors", []),
            source.config.get("whitelist", []),
        )
        if new_ds is None:
            raise RuntimeError(f"Could not create dataset '{new_dataset_name}'.")

    all_instances = source.all_instances()
    videos = sorted(
        {
            os.path.join(project.path, i["video"])
            for i in all_instances
            # never re-augment an augmented sibling (a source dataset that
            # already went through resync_aug_labels holds *_aug instances;
            # without this, every chain produces *_aug_aug.mp4 copies and
            # doubly-remapped labels)
            if i.get("video") and not is_aug_video(i["video"])
        }
    )
    if not videos:
        log_message("No videos found in source dataset to augment.", "WARN")
        return new_ds

    processed: Dict[str, str] = {}
    for i, src in enumerate(videos):
        if progress_callback:
            progress_callback(
                (i + 1) / len(videos) * 100.0, f"Processing video {i + 1} of {len(videos)}"
            )
        out = aug_path_for(src)
        if os.path.exists(out):
            log_message(f"Skipping already augmented video: {os.path.basename(out)}")
        else:
            log_message(f"Augmenting: {os.path.basename(src)} -> {os.path.basename(out)}")
            augment_video(src, out)
        processed[src] = out

    # Source labels plus remapped copies pointing at the augmented videos.
    # Dedupe against aug instances the source dataset ALREADY holds (a source
    # that went through resync_aug_labels carries both v.mp4 and v_aug.mp4
    # instances): without this every chained augmentation would append a
    # second identical v_aug instance per source instance, double-weighting
    # those windows in training and doubling every instance/frame count.
    new_labels = {b: list(insts) for b, insts in source.labels.get("labels", {}).items()}
    existing_aug = {
        (b, str(i.get("video")).replace("\\", "/"),
         int(i.get("start", -1)), int(i.get("end", -1)))
        for b, insts in new_labels.items()
        for i in insts
        if is_aug_video(str(i.get("video", "")))
    }
    for inst in all_instances:
        src = os.path.join(project.path, inst["video"])
        if src in processed:
            remapped = dict(inst)
            # Normalize separators like resync_aug_labels: Windows relpath
            # output ('s\\m\\v_aug.mp4') would never match existing_aug keys,
            # re-appending a duplicate instance on every chained augmentation.
            remapped["video"] = os.path.relpath(
                processed[src], start=project.path
            ).replace("\\", "/")
            label = remapped.get("label")
            key = (label, remapped["video"],
                   int(remapped.get("start", -1)), int(remapped.get("end", -1)))
            if label in new_labels and key not in existing_aug:
                new_labels[label].append(remapped)
    new_ds.labels = dict(source.labels)
    new_ds.labels["labels"] = new_labels
    new_ds.save_labels()
    log_message(f"Augmentation complete: dataset '{new_dataset_name}' ready.")
    return new_ds


def resync_aug_labels(project, dataset_name: str) -> int:
    """Re-copy source-video labels onto their _aug siblings (used after the
    source labels change; reference: backend/workthreads.py:1310-1377).
    Returns the number of aug instances after resync."""
    ds = project.datasets.get(dataset_name)
    if ds is None:
        raise ValueError(f"Dataset '{dataset_name}' not found.")
    labels = ds.labels.get("labels", {})
    count = 0
    for behavior, insts in labels.items():
        sources = [i for i in insts if not is_aug_video(str(i.get("video", "")))]
        fresh: List[dict] = []
        for inst in sources:
            aug_rel = aug_path_for(str(inst["video"]))
            if os.path.exists(os.path.join(project.path, aug_rel)):
                remapped = dict(inst)
                remapped["video"] = aug_rel.replace("\\", "/")
                fresh.append(remapped)
        labels[behavior] = sources + fresh
        count += len(fresh)
    ds.save_labels()
    return count
