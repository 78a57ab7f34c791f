"""Labeling session engine: server-side video scrubber + instance editor.

Rebuild of the reference's guided-labeling state machine
(backend/label_train_page.py:593-715,1098-1631,1942-2105) as one class with no
UI coupling: every mutation returns/emits render payloads through the
Callbacks fan-out, so any frontend (websocket, tests, notebooks) can drive it.

Core semantics preserved:

- the session buffer is the single source of truth for one video: human labels
  plus (in review mode) model predictions filtered by confidence with human
  intervals subtracted
- edits promote predictions to human labels (confidence stripped,
  ``_confirmed`` set) with ancestry tracking (``_parent_id``) and deletion
  suppression so refiltering never resurrects replaced/deleted ghosts
- boundary nudges trim overlapping neighbors and drop collapsed ones
- commit is a "scorched-earth" rewrite of that video's entries in labels.yaml,
  stripping session-only keys
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cbas_tpu_torch.app.state import Callbacks
from cbas_tpu_torch.core.config import load_yaml, dump_yaml
from cbas_tpu_torch.core.labels import subtract_intervals
from cbas_tpu_torch.core.project import Dataset, Project
from cbas_tpu_torch.utils.logging import log_message

TIMELINE_WIDTH = 500

# tab20-like categorical palette (hex), used for behavior colors.
BEHAVIOR_COLORS = [
    "#1f77b4", "#aec7e8", "#ff7f0e", "#ffbb78", "#2ca02c", "#98df8a",
    "#d62728", "#ff9896", "#9467bd", "#c5b0d5", "#8c564b", "#c49c94",
    "#e377c2", "#f7b6d2", "#7f7f7f", "#c7c7c7", "#bcbd22", "#dbdb8d",
    "#17becf", "#9edae5",
]


def behavior_color(i: int) -> str:
    return BEHAVIOR_COLORS[i % len(BEHAVIOR_COLORS)]


def _sig(inst: dict) -> Tuple:
    return (inst["start"], inst["end"], inst["label"])


def _hex_to_bgr(hx: str) -> Tuple[int, int, int]:
    hx = hx.lstrip("#")
    return (int(hx[4:6], 16), int(hx[2:4], 16), int(hx[0:2], 16))


def raster_to_blob(
    raster: Sequence[int],
    colors: Sequence[str],
    playhead_frac: Optional[float] = None,
    height: int = 28,
) -> str:
    """Colorize a behavior-index timeline raster into a base64 JPEG strip.

    Our own frontend colorizes the raw raster on a canvas; the REFERENCE
    frontend expects server-rendered timeline image blobs
    (updateLabelImageSrc's timeline/zoom args, label_train_page.js:904), so
    the eel bridge renders them here. -1 entries are the unlabeled
    background; ``playhead_frac`` draws the white playhead line."""
    from cbas_tpu_torch.app.media import _to_jpeg_b64

    raster = np.asarray(raster, np.int32)
    img = np.full((height, len(raster), 3), 52, np.uint8)  # #343434 background
    for b in np.unique(raster):
        if b < 0:
            continue
        img[:, raster == b] = _hex_to_bgr(colors[int(b) % len(colors)])
    if playhead_frac is not None:
        x = min(len(raster) - 1, max(0, int(playhead_frac * len(raster))))
        img[:, max(0, x - 1) : x + 2] = (255, 255, 255)
    return _to_jpeg_b64(img)


class LabelingSession:
    """One interactive labeling session over a single video."""

    def __init__(
        self,
        project: Project,
        dataset_name: str,
        video_path: str,
        preloaded_instances: Optional[List[dict]] = None,
        filter_for_behavior: Optional[str] = None,
        callbacks: Optional[Callbacks] = None,
        model_name: str = "",
        open_capture: bool = True,
        playback: bool = False,
        behaviors_override: Optional[List[str]] = None,
    ):
        if dataset_name not in project.datasets:
            raise ValueError(f"Dataset '{dataset_name}' not found.")
        if not os.path.exists(video_path):
            raise FileNotFoundError(f"Video to label does not exist: {video_path}")

        self.project = project
        # Re-read the dataset from disk for a fresh label view.
        self.dataset = Dataset(project.datasets[dataset_name].path)
        project.datasets[dataset_name] = self.dataset
        self.video_path = video_path
        self.rel_video = os.path.relpath(video_path, start=project.path).replace("\\", "/")
        self.filter_for_behavior = filter_for_behavior
        self.callbacks = callbacks or Callbacks()
        self.model_name = model_name

        # Playback renders the MODEL's behavior vocabulary (the dataset's
        # list may not cover it); editing sessions use the dataset's.
        self.behaviors: List[str] = list(
            behaviors_override
            if behaviors_override is not None
            else self.dataset.labels.get("behaviors", [])
        )
        self.colors: List[str] = [behavior_color(i) for i in range(len(self.behaviors))]

        # Scrubber state
        self.frame_index = 0
        self.total_frames = 0
        self._capture = None
        if open_capture:
            import cv2

            cap = cv2.VideoCapture(video_path)
            if cap.isOpened():
                self._capture = cap
                self.total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

        # Editing state
        self.pending_type = -1     # behavior index of an in-progress label
        self.pending_start = -1    # start frame of an in-progress label
        self.selected_index = -1
        self.history: List[dict] = []
        self.dirty: set = set()
        self.suppressed_ids: set = set()
        self.confirmation_mode = False
        self.confidence_threshold = 100  # percent
        self.filter_mode = "below"

        # Buffer = human labels for this video (+ filtered predictions).
        self.buffer: List[dict] = []
        for insts in self.dataset.labels.get("labels", {}).values():
            for inst in insts:
                if str(inst.get("video", "")).replace("\\", "/") == self.rel_video:
                    copy = dict(inst)
                    copy["video"] = self.rel_video
                    self.buffer.append(copy)

        self.mode = "scratch"
        self.unfiltered_predictions: List[dict] = []
        if playback:
            # Read-only playback: the predictions ARE the timeline — every
            # instance regardless of confidence, no human-interval
            # subtraction, human labels not mixed in.
            self.mode = "playback"
            self.buffer = [dict(p) for p in (preloaded_instances or [])]
        elif preloaded_instances:
            self.mode = "review"
            self.unfiltered_predictions = [dict(p) for p in preloaded_instances]
            human_intervals = sorted(
                (int(h["start"]), int(h["end"])) for h in self.buffer
            )
            threshold = self.confidence_threshold / 100.0
            for pred in self.unfiltered_predictions:
                if pred.get("confidence", 1.0) >= threshold:
                    continue
                for piece in subtract_intervals(pred, human_intervals):
                    self.buffer.append(piece)

        self.buffer.sort(key=lambda x: x["start"])

    # -- helpers ---------------------------------------------------------------

    def close(self) -> None:
        if self._capture is not None:
            self._capture.release()
            self._capture = None

    def _instance_at(self, frame: int) -> Tuple[int, Optional[dict]]:
        for i, inst in enumerate(self.buffer):
            if inst.get("start", -1) <= frame <= inst.get("end", -1):
                return i, inst
        return -1, None

    def _blocked_by_filter(self, inst: Optional[dict]) -> bool:
        return (
            self.filter_for_behavior is not None
            and inst is not None
            and inst.get("label") != self.filter_for_behavior
        )

    def _promote(self, inst: dict) -> None:
        """Prediction touched by the user -> human label with ancestry."""
        if "confidence" in inst:
            if "_parent_id" not in inst:
                inst["_parent_id"] = _sig(inst)
            del inst["confidence"]
            inst["_confirmed"] = True

    # -- navigation -------------------------------------------------------------

    def jump_to_frame(self, frame: int) -> None:
        if self.total_frames > 0:
            self.frame_index = max(0, min(int(frame), self.total_frames - 1))
        else:
            self.frame_index = max(0, int(frame))

    def next_frame(self, shift: int) -> None:
        self.jump_to_frame(self.frame_index + shift)

    def click_timeline(self, x: int, width: int = TIMELINE_WIDTH) -> None:
        if self.total_frames > 0:
            self.jump_to_frame(int(x * self.total_frames / width))

    def jump_to_instance(self, direction: int) -> Optional[dict]:
        """Tab through instances; returns the newly selected instance."""
        if not self.buffer:
            self.selected_index = -1
            return None
        ordered = sorted(self.buffer, key=lambda x: x.get("start", 0))
        inside = -1
        for i, inst in enumerate(ordered):
            if inst.get("start", -1) <= self.frame_index <= inst.get("end", -1):
                inside = i
                break
        if inside != -1:
            target = ordered[(inside + direction) % len(ordered)]
        elif direction > 0:
            target = next(
                (i for i in ordered if i.get("start", -1) > self.frame_index),
                ordered[0],
            )
        else:
            target = next(
                (i for i in reversed(ordered) if i.get("start", -1) < self.frame_index),
                ordered[-1],
            )
        self.frame_index = int(target.get("start", 0))
        self.selected_index = self.buffer.index(target)
        self.callbacks.emit("highlightBehaviorRow", target.get("label"))
        self.callbacks.emit(
            "updateConfidenceBadge", target.get("label"), target.get("confidence")
        )
        return target

    # -- edits -----------------------------------------------------------------

    def _editable(self) -> bool:
        if self.mode == "playback":
            log_message("Playback session is read-only.", "WARN")
            return False
        return True

    def label_frame(self, value: int) -> None:
        """Number-key handler: start/finish a new label, or relabel under playhead
        (reference: label_train_page.py:1520-1572)."""
        if not self._editable() or not 0 <= value < len(self.behaviors):
            return
        idx, under = self._instance_at(self.frame_index)
        if self.filter_for_behavior is not None and self._blocked_by_filter(under):
            log_message("Edit blocked: non-target behavior in review-by-behavior mode.", "WARN")
            return

        if idx != -1 and self.pending_type == -1:
            # Relabel the instance under the playhead.
            inst = self.buffer[idx]
            self.dirty.add(id(inst))
            self._promote(inst)
            inst["label"] = self.behaviors[value]
        elif value == self.pending_type:
            self._finish_pending(self.behaviors[value])
            self.pending_type, self.pending_start = -1, -1
        else:
            self.pending_type, self.pending_start = value, self.frame_index
            self.selected_index = -1

    def _finish_pending(self, behavior: str) -> None:
        """Close the in-progress label (second press of the same key) and add
        it to the buffer unless it overlaps an existing instance
        (reference: label_train_page.py:1488-1517)."""
        if self.pending_start == -1:
            return
        start = min(self.pending_start, self.frame_index)
        end = max(self.pending_start, self.frame_index)
        if start == end:
            return
        for inst in self.buffer:
            if max(start, inst["start"]) <= min(end, inst["end"]):
                self.callbacks.emit(
                    "showErrorOnLabelTrainPage",
                    "Overlapping behavior region! Behavior not recorded.",
                )
                return
        new_inst = {
            "video": self.rel_video,
            "start": start,
            "end": end,
            "label": behavior,
        }
        self.buffer.append(new_inst)
        self.buffer.sort(key=lambda x: x["start"])
        self.dirty.add(id(new_inst))
        self.history.append(new_inst)

    def delete_instance(self) -> Optional[dict]:
        if not self._editable():
            return None
        idx, inst = self._instance_at(self.frame_index)
        if inst is None:
            return None
        if self._blocked_by_filter(inst):
            log_message("Edit blocked: cannot delete a non-target behavior.", "WARN")
            return None
        removed = self.buffer.pop(idx)
        if "confidence" in removed:
            self.suppressed_ids.add(_sig(removed))
        if "_parent_id" in removed:
            # A PROMOTED prediction (edited, confidence stripped) keeps its
            # original identity in _parent_id; without suppressing it the
            # next refilter resurrects the ghost the user just deleted.
            # (The reference only suppresses the confidence-bearing case,
            # label_train_page.py:1595-1598 — same resurrection there.)
            self.suppressed_ids.add(tuple(removed["_parent_id"]))
        self.dirty.add(f"deleted_{removed['label']}")
        if removed in self.history:
            self.history.remove(removed)
        self.selected_index = -1
        return removed

    def undo_last(self) -> Optional[dict]:
        if not self._editable():
            return None
        if not self.history:
            return None
        last = self.history.pop()
        try:
            self.buffer.remove(last)
            self.selected_index = -1
            return last
        except ValueError:
            return None

    def confirm_selected(self) -> Optional[bool]:
        """Toggle the selected instance's confirmed state (keeps confidence)."""
        if not self._editable():
            return None
        if not 0 <= self.selected_index < len(self.buffer):
            return None
        inst = self.buffer[self.selected_index]
        if self._blocked_by_filter(inst):
            # Same guard as every other edit path: in review-by-behavior
            # mode, Tab can land on an off-target prediction — confirming it
            # would commit it as a human label and bypass the mode's scope.
            log_message("Edit blocked: cannot confirm a non-target behavior.", "WARN")
            return None
        inst["_confirmed"] = not inst.get("_confirmed", False)
        return inst["_confirmed"]

    def update_instance_boundary(self, boundary_type: str) -> bool:
        """Nudge the selected instance's start/end to the playhead, trimming
        overlapped neighbors (reference: label_train_page.py:1408-1464)."""
        if not self._editable() or not 0 <= self.selected_index < len(self.buffer):
            return False
        inst = self.buffer[self.selected_index]
        if self._blocked_by_filter(inst):
            log_message("Edit blocked: non-target behavior boundaries.", "WARN")
            return False
        frame = self.frame_index

        # Validate BEFORE promoting: a no-op nudge must not flag an
        # unreviewed prediction as a confirmed human label or dirty the
        # session.
        if boundary_type == "start":
            if frame >= inst["end"]:
                return False
            new_start, new_end = frame, inst["end"]
        elif boundary_type == "end":
            if frame <= inst["start"]:
                return False
            new_start, new_end = inst["start"], frame
        else:
            return False
        self.dirty.add(id(inst))
        self._promote(inst)

        drop = []
        for i, nb in enumerate(self.buffer):
            if i == self.selected_index:
                continue
            if max(new_start, nb["start"]) <= min(new_end, nb["end"]):
                if boundary_type == "start" and new_start <= nb["end"]:
                    nb["end"] = new_start - 1
                elif boundary_type == "end" and new_end >= nb["start"]:
                    nb["start"] = new_end + 1
                if nb["start"] > nb["end"]:
                    # Strict: [f, f] is a VALID 1-frame label everywhere else
                    # (counts, manifests, subtraction). The reference's >=
                    # (label_train_page.py:1452) silently destroys a label on
                    # a frame the edit never claimed.
                    drop.append(i)
        for i in sorted(drop, reverse=True):
            if i < self.selected_index:
                self.selected_index -= 1
            self.buffer.pop(i)

        inst = self.buffer[self.selected_index]
        inst["start" if boundary_type == "start" else "end"] = frame
        return True

    # -- confidence refiltering ---------------------------------------------------

    def refilter(self, new_threshold: int, mode: str = "below") -> None:
        """Re-filter predictions against the buffer with ancestry + deletion
        suppression (reference: label_train_page.py:1162-1220)."""
        self.confidence_threshold = new_threshold
        self.filter_mode = mode
        if not self.unfiltered_predictions:
            return

        preserved: List[dict] = []
        suppression = set(self.suppressed_ids)
        for inst in self.buffer:
            if "confidence" not in inst or inst.get("_confirmed", False):
                preserved.append(inst)
                suppression.add(_sig(inst))
                if "_parent_id" in inst:
                    suppression.add(tuple(inst["_parent_id"]))

        # Re-apply the human-interval subtraction from __init__: raw
        # predictions re-entering the buffer must not overlap the preserved
        # (human/confirmed) instances, or frame counts double-count and new
        # labels hit the overlap guard.
        kept_intervals = sorted(
            (int(h["start"]), int(h["end"])) for h in preserved
        )
        threshold = new_threshold / 100.0
        fresh = []
        for p in self.unfiltered_predictions:
            conf = p.get("confidence", 0.0)
            passes = conf >= threshold if mode == "above" else conf < threshold
            if passes and _sig(p) not in suppression:
                for piece in subtract_intervals(p, kept_intervals):
                    if _sig(piece) not in suppression:
                        fresh.append(piece)

        self.buffer = sorted(preserved + fresh, key=lambda x: x["start"])
        self.selected_index = -1
        self.callbacks.emit("highlightBehaviorRow", None)
        self.callbacks.emit("updateConfidenceBadge", None, None)

    # -- commit ---------------------------------------------------------------

    def has_changes(self) -> bool:
        return bool(self.dirty) or any(i.get("_confirmed") for i in self.buffer)

    def save(self) -> dict:
        """Commit the session: rewrite this video's labels in labels.yaml
        (reference: label_train_page.py:1098-1160)."""
        if self.mode == "playback":
            self.confirmation_mode = False  # un-stage; nothing commits here
            return {"status": "error", "message": "Playback session is read-only."}
        commit = [
            inst
            for inst in self.buffer
            if "confidence" not in inst or inst.get("_confirmed", False)
        ]
        if not self.has_changes():
            # Un-stage before returning: the frontend stages confirmation_mode
            # ahead of the save RPC, and leaving it set would keep every
            # unconfirmed prediction hidden from the timeline after a no-op
            # save (the re-render in Api.save_session_labels restores them).
            self.confirmation_mode = False
            log_message("No changes detected in labeling session; nothing to save.")
            return {"status": "no_changes"}

        master = load_yaml(self.dataset.labels_path)
        # Heal a truncated/hand-emptied labels.yaml like Dataset.__init__
        # does: the user's reviewed labels must still commit.
        if not isinstance(master, dict):
            master = {"behaviors": list(self.behaviors), "labels": {}}
        master.setdefault("labels", {})
        for behavior in master.get("labels", {}):
            master["labels"][behavior] = [
                i
                # `or []`: a hand-edited `behavior:` key reads as YAML null;
                # this raw reload bypasses Dataset.__init__'s normalization,
                # and the user's reviewed labels must still commit.
                for i in (master["labels"].get(behavior) or [])
                if str(i.get("video", "")).replace("\\", "/") != self.rel_video
            ]
        for inst in commit:
            clean = dict(inst)
            # _original_* appear only in label files written by the
            # reference implementation's sessions; nothing here writes them,
            # but strip them on commit so migrated projects stay clean.
            for key in ("confidence", "confidences", "_original_start",
                        "_original_end", "_confirmed", "_parent_id"):
                clean.pop(key, None)
            master["labels"].setdefault(clean["label"], []).append(clean)
        dump_yaml(master, self.dataset.labels_path)
        self.dataset.labels = master
        try:
            self.dataset.update_instance_counts_in_config()
        except Exception as e:
            log_message(f"Could not update instance counts after saving: {e}", "ERROR")
        log_message(f"Saved {len(commit)} labels for {self.rel_video}.")
        self.confirmation_mode = False
        return {
            "status": "success",
            "video_path": self.rel_video,
            "dataset_name": self.dataset.name,
        }

    # -- counts + rendering -----------------------------------------------------

    def counts(self) -> Dict[str, int]:
        out = {b: 0 for b in self.behaviors}
        for inst in self.buffer:
            if inst.get("label") in out and (
                "confidence" not in inst or inst.get("_confirmed")
            ):
                out[inst["label"]] += int(inst["end"]) - int(inst["start"]) + 1
        return out

    def instance_counts(self) -> Dict[str, int]:
        """Per-behavior committed/confirmed instance counts — the reference
        shows 'instanceCount / frameCount' per behavior row while labeling
        (frontend/js/label_train_page.js:939-943)."""
        out = {b: 0 for b in self.behaviors}
        for inst in self.buffer:
            if inst.get("label") in out and (
                "confidence" not in inst or inst.get("_confirmed")
            ):
                out[inst["label"]] += 1
        return out

    def visible_instances(self) -> List[dict]:
        if self.confirmation_mode:
            return [
                i for i in self.buffer
                if "confidence" not in i or i.get("_confirmed", False)
            ]
        return self.buffer

    def timeline_raster(
        self,
        width: int = TIMELINE_WIDTH,
        view_start: float = 0.0,
        view_end: Optional[float] = None,
    ) -> np.ndarray:
        """Behavior-index raster of the [view_start, view_end) frame window
        (-1 = unlabeled); the full timeline by default.

        The UI colorizes this; tests assert on it directly.
        """
        raster = np.full(width, -1, np.int32)
        if view_end is None:
            view_end = float(max(1, self.total_frames))
        span = max(1e-9, view_end - view_start)
        index_of = {b: i for i, b in enumerate(self.behaviors)}
        for inst in self.visible_instances():
            b = index_of.get(inst.get("label"))
            if b is None:
                continue
            x0 = int((int(inst["start"]) - view_start) * width / span)
            x1 = int((int(inst["end"]) + 1 - view_start) * width / span)
            x1 = max(x0 + 1, x1)
            x0, x1 = max(0, x0), min(x1, width)
            if x0 < x1:
                raster[x0:x1] = b
        return raster

    def zoom_window(self, frac: float = 0.10) -> Tuple[float, float]:
        """Fixed-width zoom window: ``frac`` of the video, centered on the
        selected instance's midpoint if one is selected, else the playhead
        (reference: backend/label_train_page.py:1963-1974)."""
        center = float(self.frame_index)
        if 0 <= self.selected_index < len(self.buffer):
            inst = self.buffer[self.selected_index]
            center = (int(inst.get("start", 0)) + int(inst.get("end", 0))) / 2.0
        half = self.total_frames * frac / 2.0
        lo = max(0.0, center - half)
        hi = min(float(self.total_frames), center + half)
        return lo, hi

    def render_payload(self, size: int = 500) -> dict:
        """Current frame (base64 JPEG, if a capture is open) + timelines +
        playhead + selection metadata — everything the UI needs per step."""
        frame_b64 = None
        if self._capture is not None:
            import cv2
            from cbas_tpu_torch.app.media import _to_jpeg_b64

            self._capture.set(cv2.CAP_PROP_POS_FRAMES, self.frame_index)
            ok, frame = self._capture.read()
            if ok:
                frame = cv2.resize(frame, (size, size), interpolation=cv2.INTER_AREA)
                frame_b64 = _to_jpeg_b64(frame)
        sel = (
            self.buffer[self.selected_index]
            if 0 <= self.selected_index < len(self.buffer)
            else None
        )
        zoom_lo, zoom_hi = self.zoom_window()
        payload = {
            "frame": frame_b64,
            "frame_index": self.frame_index,
            "total_frames": self.total_frames,
            "video_name": os.path.basename(self.video_path),
            "timeline": self.timeline_raster().tolist(),
            # fixed-width (10%) zoom raster around the playhead/selection —
            # the reference renders a second, zoomed timeline every frame
            # (backend/label_train_page.py:1976-2000)
            "zoom_timeline": self.timeline_raster(
                view_start=zoom_lo, view_end=zoom_hi
            ).tolist(),
            "zoom_start": zoom_lo,
            "zoom_end": zoom_hi,
            "behaviors": self.behaviors,
            "colors": self.colors,
            "selected": sel,
            "pending": {"type": self.pending_type, "start": self.pending_start},
            "mode": self.mode,
            "confirmation_mode": self.confirmation_mode,
            "counts": self.counts(),
            "instance_counts": self.instance_counts(),
        }
        self.callbacks.emit("updateLabelImageSrc", payload)
        return payload
