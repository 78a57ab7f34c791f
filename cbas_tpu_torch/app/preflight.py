"""Pre-training gates and review playlists.

Host-side checks that run before expensive device work:

- :func:`run_preflight_check` — simulates the 3-way subject split allocation
  and verifies behavior coverage (reference: backend/label_train_page.py:43-122)
- :func:`check_dataset_files_ready` — verifies every labeled video has its
  embedding file before training starts (reference: label_train_page.py:246-291)
- :func:`get_disagreement_playlist` — the review queue from
  disagreement_report.yaml: per-video best (highest-confidence) error, aug
  videos remapped to their canonical sources, top N
  (reference: label_train_page.py:1637-1701)
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Tuple

from cbas_tpu_torch.core.config import load_yaml
from cbas_tpu_torch.core.project import Project
from cbas_tpu_torch.core.splits import subject_of
from cbas_tpu_torch.utils.naming import h5_path_for_video


def run_preflight_check(project: Project, dataset_name: str, test_split: float) -> dict:
    """Dry-run of the split a training run would actually make.

    The reference's preflight allocates by INSTANCE fractions while its real
    splitter slices SUBJECT counts (label_train_page.py:43-122 vs
    splits.py:50-141) — with few subjects preflight can approve a split whose
    validation set comes out empty, silently disabling early stopping. Here
    the check runs the production ``RandomSplitProvider`` at the same ratios
    the orchestrator derives (``default_split_ratios``), so what's validated
    is what will run:

    - subject-count slicing (empty-val detection is exact, seed-free)
    - 3 trial seeds of the stratified 10-attempt search; if none covers
      every behavior in train+val, training would take the relaxed fallback
      — reported as a warning, not a pass.
    """
    try:
        from cbas_tpu_torch.core.splits import RandomSplitProvider

        dataset = project.datasets.get(dataset_name)
        if dataset is None:
            return {"is_valid": False, "message": "Dataset not found."}
        behaviors = set(dataset.config.get("behaviors", []))
        if not behaviors:
            return {"is_valid": False, "message": "Dataset has no defined behaviors."}
        # Gather instances EXACTLY like the orchestrator (run_training_job
        # selects by behavior KEY, not by the instance's label string): a
        # stale label key must not change the verdict, and a whitespace-
        # padded label under a valid key must still count — both cases
        # where a label-string filter would diverge from what training does.
        labels_doc = dataset.labels.get("labels", {})
        keyed = [
            (b, inst)
            for b in sorted(behaviors)
            for inst in (labels_doc.get(b) or [])
        ]
        all_insts = [inst for _, inst in keyed]
        if not all_insts:
            return {
                "is_valid": False,
                "message": "No labeled instances for the dataset's behaviors.",
            }

        test = max(0.0, float(test_split))
        if test >= 0.7:
            return {
                "is_valid": False,
                "message": f"Test split {test:.0%} leaves too little for train+validation.",
            }

        group_behaviors: Dict[str, set] = defaultdict(set)
        for b, inst in keyed:  # by behavior KEY, matching the gather above
            group_behaviors[subject_of(inst)].add(b)
        groups = sorted(group_behaviors.keys())
        # train+val always need their own subjects; the test slice needs a
        # third only when one is actually reserved (test_split 0 trains fine
        # with 2 subjects: splits.py's zero-test slicer yields train+val).
        min_groups = 3 if test > 0 else 2
        if len(groups) < min_groups:
            return {
                "is_valid": False,
                "message": (
                    f"Not enough subjects/groups ({len(groups)}) to form a "
                    f"{'3-way' if test > 0 else 'train/validation'} split."
                ),
            }
        # THE orchestrator's derivation, not a copy of it — preflight exists
        # to validate exactly what training will run, so the two must be
        # mechanically incapable of drifting apart.
        from cbas_tpu_torch.core.config import TrainingConfig
        from cbas_tpu_torch.engine.orchestrator import default_split_ratios

        ratios = default_split_ratios(
            TrainingConfig(use_test=test > 0, test_split=test)
        )
        provider = RandomSplitProvider(seed=0, split_ratios=ratios)

        # Structural sizing via the provider's own slicer: exact and
        # seed-independent (shuffles permute, counts don't change).
        train_s, val_s, _ = provider._slice_by_ratio(list(groups))
        if not train_s or not val_s:
            return {
                "is_valid": False,
                "message": (
                    f"With {len(groups)} subjects at these ratios the "
                    "validation set would be EMPTY — training would run "
                    "without early stopping. Add labeled subjects or reduce "
                    "the test split."
                ),
            }

        # Stratification: mirror training's shuffle search on trial seeds.
        for seed in (0, 1, 2):
            try:
                t_g, v_g, test_g = RandomSplitProvider(
                    seed=seed, split_ratios=ratios
                ).get_split(0, groups, all_insts, sorted(behaviors))
            except RuntimeError:
                continue
            test_b = {b for g in test_g for b in group_behaviors[g]}
            if test_b and test_b != behaviors:
                return {
                    "is_valid": True,
                    "message": (
                        f"Warning: Test set will be missing behaviors: "
                        f"{', '.join(sorted(behaviors - test_b))}. Proceed with caution."
                    ),
                }
            return {"is_valid": True, "message": "Split is valid. Ready to train."}
        return {
            "is_valid": True,
            "message": (
                "Warning: no behavior-covering train/validation split found "
                "on trial seeds — training will fall back to a plain subject "
                "split and rare behaviors may be missing from validation."
            ),
        }
    except Exception as e:
        return {"is_valid": False, "message": f"An unexpected error occurred: {e}"}


def check_dataset_files_ready(project: Project, dataset_name: str) -> Tuple[bool, str]:
    """All labeled videos must have their ``*_cls.h5`` before training."""
    dataset = project.datasets.get(dataset_name)
    if dataset is None:
        return False, f"Dataset '{dataset_name}' not found."
    try:
        videos = {
            str(inst["video"])
            for insts in dataset.labels.get("labels", {}).values()
            for inst in insts
            if "video" in inst
        }
        if not videos:
            return False, "The dataset contains no labeled video instances."
        missing = [
            os.path.basename(rel.replace("\\", "/"))
            for rel in videos
            # Normalize Windows separators like every other labels.yaml
            # consumer (splits.subject_of, labeling, core/labels) — literal
            # backslashes in the joined path would report every H5 missing.
            if not os.path.exists(
                h5_path_for_video(os.path.join(project.path, rel.replace("\\", "/")))
            )
        ]
        if not missing:
            return True, "All necessary files are ready for training."
        msg = (
            f"{len(missing)} of {len(videos)} required feature files (.h5) "
            "are still missing."
        )
        shown = missing[:3]
        msg += f"\nMissing: {', '.join(shown)}" + (", and others..." if len(missing) > 3 else "")
        return False, msg
    except Exception as e:
        return False, f"An unexpected error occurred: {e}"


def get_disagreement_playlist(
    project: Project, dataset_name: str, max_items: int = 50
) -> List[dict]:
    """Review queue: one highest-confidence disagreement per video, aug
    videos remapped to their canonical sources, sorted by confidence."""
    dataset = project.datasets.get(dataset_name)
    if dataset is None:
        return []
    report_path = os.path.join(dataset.path, "disagreement_report.yaml")
    if not os.path.exists(report_path):
        return []
    items = load_yaml(report_path) or []

    best_per_video: Dict[str, dict] = {}
    for item in items:
        video = str(item.get("video_path", ""))
        # _aug videos point the reviewer at the canonical source video.
        stem, ext = os.path.splitext(video)
        if stem.endswith("_aug"):
            canonical = stem[: -len("_aug")] + ext
            if os.path.exists(os.path.join(project.path, canonical)):
                item = dict(item)
                item["video_path"] = canonical
                video = canonical
        cur = best_per_video.get(video)
        if cur is None or item.get("model_confidence", 0) > cur.get("model_confidence", 0):
            best_per_video[video] = item

    playlist = sorted(
        best_per_video.values(),
        key=lambda x: x.get("model_confidence", 0),
        reverse=True,
    )
    return playlist[:max_items]
