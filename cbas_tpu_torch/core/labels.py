"""Label instances: prediction→instance conversion and label hygiene.

Pure host-side transformations over the labels.yaml instance schema
(``{"video": rel_path, "start": int|float, "end": int|float, "label": str
[, "confidence"]}``) — :func:`clean_and_sort_labels` normalizes start/end to
float, matching the reference's cleanup output (label_train_page.py:888-889)
so cleaned files round-trip between implementations.
Behavior mirrors the reference's conversion and cleanup tools
(reference: backend/cbas.py:903-956, backend/label_train_page.py:797-978),
except that same-label overlaps UNION instead of losing the remainder — see
docs/Compatibility.md "Documented deviations".
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
from scipy.signal import medfilt

Instance = Dict[str, object]


# ---------------------------------------------------------------------------
# Predictions → instances
# ---------------------------------------------------------------------------

def predictions_to_instances(
    df: pd.DataFrame,
    behaviors: Sequence[str],
    video_path: str,
    threshold: float = 0.7,
) -> List[Instance]:
    """Thresholded event extraction from a per-frame probability table.

    A frame is inside an event while its max prob >= threshold; events close
    when the prob dips below threshold or the argmax label changes
    (reference: backend/cbas.py:903-926).
    """
    if not behaviors or any(b not in df.columns for b in behaviors):
        return []
    probs = df[list(behaviors)].to_numpy()
    pred_idx = probs.argmax(axis=1)
    max_prob = probs.max(axis=1)

    instances: List[Instance] = []
    in_event, start, label_i = False, 0, -1
    for i in range(len(df)):
        above = max_prob[i] >= threshold
        if not in_event and above:
            in_event, start, label_i = True, i, pred_idx[i]
        elif in_event and (not above or pred_idx[i] != label_i):
            if i - 1 >= start:
                instances.append(
                    {"video": video_path, "start": start, "end": i - 1, "label": behaviors[label_i]}
                )
            in_event = False
            if above:
                in_event, start, label_i = True, i, pred_idx[i]
    if in_event and len(df) - 1 >= start:
        instances.append(
            {"video": video_path, "start": start, "end": len(df) - 1, "label": behaviors[label_i]}
        )
    return instances


def predictions_to_instances_with_confidence(
    df: pd.DataFrame,
    behaviors: Sequence[str],
    video_path: str,
    smoothing_window: int = 1,
) -> Tuple[List[Instance], pd.DataFrame]:
    """Argmax block grouping with optional median smoothing + block confidence.

    Each contiguous run of the (optionally median-filtered) argmax label
    becomes one instance whose confidence is the mean max-probability over the
    block (reference: backend/cbas.py:928-956). Returns (instances, annotated df).
    """
    df = df.copy()
    if not behaviors or any(b not in df.columns for b in behaviors):
        return [], df
    probs = df[list(behaviors)].to_numpy()
    pred_idx = probs.argmax(axis=1)
    max_prob = probs.max(axis=1)
    df["predicted_label"] = [behaviors[i] for i in pred_idx]
    df["max_prob"] = max_prob

    if smoothing_window > 1:
        if smoothing_window % 2 == 0:
            smoothing_window += 1
        smoothed = medfilt(pred_idx, kernel_size=smoothing_window).astype(int)
        group_labels = [behaviors[i] if 0 <= i < len(behaviors) else None for i in smoothed]
    else:
        group_labels = list(df["predicted_label"])
    df["label_for_grouping"] = group_labels

    instances: List[Instance] = []
    n = len(df)
    block_start = 0
    for i in range(1, n + 1):
        if i == n or group_labels[i] != group_labels[block_start]:
            label = group_labels[block_start]
            if label is not None:
                instances.append(
                    {
                        "video": video_path,
                        "start": block_start,
                        "end": i - 1,
                        "label": label,
                        "confidence": float(np.mean(max_prob[block_start:i])),
                    }
                )
            block_start = i
    return instances, df


# ---------------------------------------------------------------------------
# Interval algebra (used by guided labeling to subtract human-labeled spans)
# ---------------------------------------------------------------------------

def subtract_intervals(instance: Instance, holes: List[Tuple[int, int]]) -> List[Instance]:
    """Split ``instance`` around each (start, end) hole, dropping covered spans.

    Guided labeling subtracts human-labeled intervals from model predictions so
    reviewers only see unlabeled territory (reference:
    backend/label_train_page.py:665-695).
    """
    pieces = [dict(instance)]
    for h_start, h_end in holes:
        next_pieces: List[Instance] = []
        for piece in pieces:
            p_start, p_end = int(piece["start"]), int(piece["end"])
            if h_end < p_start or h_start > p_end:  # disjoint
                next_pieces.append(piece)
                continue
            if h_start > p_start:
                next_pieces.append({**piece, "start": p_start, "end": h_start - 1})
            if h_end < p_end:
                next_pieces.append({**piece, "start": h_end + 1, "end": p_end})
        pieces = next_pieces
    return [p for p in pieces if int(p["start"]) <= int(p["end"])]


# ---------------------------------------------------------------------------
# Label hygiene
# ---------------------------------------------------------------------------

def analyze_label_conflicts(labels_doc: dict) -> Dict[str, int]:
    """Dry-run: count exact duplicates and pairwise adjacent overlaps."""
    seen = set()
    uniques: List[Instance] = []
    duplicates = 0
    for insts in labels_doc.get("labels", {}).values():
        if not isinstance(insts, list):
            continue
        for inst in insts:
            # Separator-normalized like clean_and_sort_labels, so the dry-run
            # report agrees with what cleaning actually removes.
            video = str(inst.get("video", "")).replace("\\", "/")
            key = (inst.get("start"), inst.get("end"), inst.get("label"), video)
            if key in seen:
                duplicates += 1
            else:
                seen.add(key)
                uniques.append(inst)

    # Adjacent-pair count, a deliberate reference mirror
    # (backend/label_train_page.py:843-850): an instance that spans several
    # later ones counts as ONE overlap even though cleaning will trim each of
    # them, so the dry-run number is a lower bound on instances modified —
    # in both implementations (the differential oracle pins this).
    overlaps = 0
    by_video: Dict[str, List[Instance]] = defaultdict(list)
    for inst in uniques:
        by_video[str(inst.get("video", "")).replace("\\", "/")].append(inst)
    for insts in by_video.values():
        if len(insts) < 2:
            continue
        insts = sorted(insts, key=lambda x: float(x["start"]))
        for a, b in zip(insts, insts[1:]):
            if float(b["start"]) <= float(a["end"]):
                overlaps += 1
    return {"total_duplicates": duplicates, "total_overlaps": overlaps}


def clean_and_sort_labels(labels_doc: dict) -> dict:
    """Dedupe → deconflict (trim) → merge same-label runs → sort.

    Conflict resolution is first-wins ordered by (start, longest); later
    instances are trimmed around earlier ones, with same-label overlaps simply
    absorbed. Mirrors the reference's cleanup semantics
    (backend/label_train_page.py:857-978) so cleaning is idempotent and
    non-destructive across implementations.
    """
    # 1. Dedupe on normalized (start, end, label, video).
    seen = set()
    all_instances: List[Instance] = []
    for insts in labels_doc.get("labels", {}).values():
        if not isinstance(insts, list):
            continue
        for inst in insts:
            video_norm = str(inst.get("video", "")).replace("\\", "/")
            key = (inst.get("start"), inst.get("end"), inst.get("label"), video_norm)
            if key in seen:
                continue
            seen.add(key)
            inst = dict(inst)
            inst["start"] = float(inst["start"])
            inst["end"] = float(inst["end"])
            inst["video"] = video_norm
            all_instances.append(inst)

    # 2. Per-video deconfliction by interval trimming.
    by_video: Dict[str, List[Instance]] = defaultdict(list)
    for inst in all_instances:
        by_video[str(inst["video"])].append(inst)

    final: List[Instance] = []
    for insts in by_video.values():
        if len(insts) < 2:
            # The single-instance shortcut still applies the start<=end
            # validity filter the multi-instance path enforces — an inverted
            # instance would otherwise survive "cleaning" and poison frame
            # counts (end - start + 1 goes negative) and manifests.
            final.extend(i for i in insts if i["start"] <= i["end"])
            continue
        insts.sort(key=lambda x: (x["start"], -(x["end"] - x["start"])))
        kept: List[Instance] = []
        for new_inst in insts:
            pieces = [new_inst]
            for existing in kept:
                survivors: List[Instance] = []
                for piece in pieces:
                    p0, p1 = piece["start"], piece["end"]
                    e0, e1 = existing["start"], existing["end"]
                    if max(p0, e0) > min(p1, e1):  # disjoint
                        survivors.append(piece)
                        continue
                    # Trim the overlap regardless of label: the step-3 merge
                    # re-unions same-label neighbours, so a same-label
                    # overlap resolves to the interval UNION. (The reference
                    # instead discards the whole overlapping piece,
                    # label_train_page.py:920 — walk[0,10] + walk[5,20]
                    # loses frames 11-20 of user labels permanently.
                    # Documented deviation: docs/Compatibility.md.)
                    if p0 < e0:
                        survivors.append({**piece, "end": e0 - 1})
                    if p1 > e1:
                        survivors.append({**piece, "start": e1 + 1})
                pieces = survivors
            kept.extend(p for p in pieces if p["start"] <= p["end"])

        # 3. Merge adjacent/overlapping same-label instances.
        kept.sort(key=lambda x: (x["label"], x["start"]))
        if not kept:
            continue
        merged = [kept[0]]
        for inst in kept[1:]:
            last = merged[-1]
            if inst["label"] == last["label"] and inst["start"] <= last["end"] + 1:
                last["end"] = max(last["end"], inst["end"])
            else:
                merged.append(inst)
        final.extend(merged)

    final.sort(key=lambda x: (x.get("label", ""), x.get("video", ""), x.get("start", 0)))

    out = dict(labels_doc)
    labels: Dict[str, List[Instance]] = defaultdict(list)
    for inst in final:
        inst.pop("_confirmed", None)
        labels[str(inst["label"])].append(inst)
    out["labels"] = dict(sorted(labels.items()))
    return out


def coverage_report(
    labels_doc: dict, behaviors: Sequence[str]
) -> Dict[str, Dict[str, int]]:
    """Per-subject frame counts for each behavior (labeling coverage view)."""
    from cbas_tpu_torch.core.splits import subject_of

    report: Dict[str, Dict[str, int]] = defaultdict(lambda: {b: 0 for b in behaviors})
    for insts in labels_doc.get("labels", {}).values():
        if not isinstance(insts, list):
            continue  # hand-edited `behavior:` (YAML null)
        for inst in insts:
            # the SAME subject definition that governs train/val/test
            # grouping (splits.subject_of), so the coverage view can never
            # drift from what the splitter will actually do
            subj = subject_of(inst)
            # strip like build_manifest does, so an instance training USES
            # ('walk ' trains as 'walk') is visible in the coverage view;
            # tolerate hand-edited instances missing start/end the same way
            # the manifest path does (skip, don't 500 the API)
            label = str(inst.get("label", "")).strip()
            start, end = inst.get("start"), inst.get("end")
            if label in report[subj] and start is not None and end is not None:
                report[subj][label] += int(end) - int(start) + 1
    return {k: dict(v) for k, v in report.items()}
