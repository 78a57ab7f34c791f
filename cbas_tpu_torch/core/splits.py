"""Group-aware, stratified subject splitting.

Copy of ``cbas_tpu/core/splits.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Behavior-compatible rebuild of the reference's split providers
(reference: backend/splits.py:18-172). Subjects are the directory component of
each instance's video path; splits are made at subject granularity so no
subject leaks across train/val/test. Seeding and RNG consumption match the
reference exactly so that identical seeds yield identical splits, and the
dataset fingerprint hashes identically so precomputed ``splits.json`` manifests
from either implementation validate against both.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

Instance = Dict[str, object]
Split = Tuple[List[str], List[str], List[str]]


def subject_of(instance: Instance) -> str:
    """Subject id = normalized directory of the instance's video path.

    Separators are normalized before dirname so label files authored on
    Windows resolve to the same subjects on Linux.
    """
    return os.path.dirname(str(instance["video"]).replace("\\", "/"))


def dataset_fingerprint(labels: Dict[str, List[Instance]]) -> str:
    """MD5 fingerprint over (sorted subjects, sorted per-label counts).

    Byte-identical to the reference's ``_generate_dataset_fingerprint``
    (backend/splits.py:18-42) so split manifests are interchangeable.
    """
    subjects = set()
    label_counts: Dict[str, int] = defaultdict(int)
    for insts in labels.values():
        for inst in insts:
            subjects.add(subject_of(inst))
            label_counts[str(inst["label"])] += 1
    hasher = hashlib.md5()
    hasher.update(str(sorted(subjects)).encode("utf-8"))
    hasher.update(str(sorted(label_counts.items())).encode("utf-8"))
    return hasher.hexdigest()


class SplitProvider:
    """Yields (train_subjects, val_subjects, test_subjects) per run index."""

    def get_split(
        self,
        run_index: int,
        all_subjects: Sequence[str],
        all_instances: Sequence[Instance],
        behaviors: Sequence[str],
        allow_relaxed_fallback: bool = False,
    ) -> Split:
        raise NotImplementedError


class RandomSplitProvider(SplitProvider):
    """Seeded stratified splitter with a subject-disjoint relaxed fallback.

    Per run it tries up to 10 shuffles (seed ``initial_seed + run_index +
    attempt + 1``) of the sorted subject list, accepting the first whose train
    and val partitions each cover every behavior. If none do and
    ``allow_relaxed_fallback`` is set, it falls back to a plain ratio split
    seeded at ``initial_seed + run_index`` (reference: backend/splits.py:50-141).
    """

    MAX_ATTEMPTS = 10

    def __init__(self, seed=None, split_ratios=(0.70, 0.15, 0.15), stratify=True):
        self.initial_seed = int(seed) if seed is not None else int(time.time())
        self.ratios = tuple(split_ratios)
        self.stratify = bool(stratify)

    def _slice_by_ratio(self, shuffled: List[str]) -> Split:
        n_total = len(shuffled)
        n_train = int(self.ratios[0] * n_total)
        n_val = int(self.ratios[1] * n_total)
        train = shuffled[:n_train]
        val = shuffled[n_train : n_train + n_val]
        test = shuffled[n_train + n_val :]
        # With a zero test ratio, leftover subjects belong to validation.
        if self.ratios[2] == 0.0 and (n_train + n_val) < n_total:
            val = shuffled[n_train:]
            test = []
        return train, val, test

    @staticmethod
    def _covers_all(insts: Sequence[Instance], behaviors: set) -> bool:
        # Deliberate reference mirror (backend/splits.py:60-64): RAW labels,
        # EXACT set equality. A single out-of-set label (e.g. 'walk ' with a
        # trailing space) therefore defeats stratification on all attempts —
        # in both implementations. Do not "fix" to strip+superset here: the
        # seed-for-seed split-equality contract (test_splits oracle) depends
        # on taking the same accept/reject path per attempt. Label hygiene
        # belongs in preflight/clean_and_sort_labels, before splitting.
        return {inst["label"] for inst in insts} == behaviors

    def get_split(
        self,
        run_index: int,
        all_subjects: Sequence[str],
        all_instances: Sequence[Instance],
        behaviors: Sequence[str],
        allow_relaxed_fallback: bool = False,
    ) -> Split:
        # ``all_subjects`` is accepted but unused — the reference signature
        # takes it and likewise re-derives subjects from the instances
        # (backend/splits.py:91-100); honoring a caller-restricted list here
        # would change RNG consumption and break seed-for-seed equality.
        current_seed = self.initial_seed + run_index

        by_subject: Dict[str, List[Instance]] = defaultdict(list)
        for inst in all_instances:
            by_subject[subject_of(inst)].append(inst)
        subjects_sorted = sorted(by_subject.keys())

        behavior_set = set(behaviors)
        for attempt in range(self.MAX_ATTEMPTS):
            rng = np.random.default_rng(current_seed + attempt + 1)
            shuffled = list(subjects_sorted)
            rng.shuffle(shuffled)
            train, val, test = self._slice_by_ratio(shuffled)
            if not self.stratify:
                return train, val, test
            train_insts = [i for s in train for i in by_subject[s]]
            val_insts = [i for s in val for i in by_subject[s]]
            if self._covers_all(train_insts, behavior_set) and self._covers_all(
                val_insts, behavior_set
            ):
                return train, val, test

        if allow_relaxed_fallback:
            from cbas_tpu_torch.utils.logging import log_message

            log_message(
                "Stratification failed after "
                f"{self.MAX_ATTEMPTS} attempts; falling back to a strict "
                "subject-disjoint ratio split. Rare behaviors may be missing "
                "from validation/test.",
                "WARN",
            )
            rng = np.random.default_rng(current_seed)
            shuffled = list(subjects_sorted)
            rng.shuffle(shuffled)
            train, val, test = self._slice_by_ratio(shuffled)
            if not train and shuffled:
                train, rest = [shuffled[0]], shuffled[1:]
                n_val = int(self.ratios[1] * len(shuffled))
                val, test = rest[:n_val], rest[n_val:]
            return train, val, test

        raise RuntimeError(
            f"Failed to generate a valid stratified split after {self.MAX_ATTEMPTS} attempts."
        )


class ManifestSplitProvider(SplitProvider):
    """Replays precomputed splits from a ``splits.json`` manifest.

    The manifest's embedded dataset fingerprint must match the current
    dataset's, guaranteeing the splits were computed for exactly this data
    (reference: backend/splits.py:144-172).
    """

    def __init__(self, manifest_path: str, fingerprint: str):
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(f"Split manifest not found: {manifest_path}")
        with open(manifest_path, "r", encoding="utf-8") as f:
            self.manifest = json.load(f)
        if self.manifest.get("dataset_fingerprint") != fingerprint:
            raise ValueError(
                "Dataset fingerprint in manifest does not match the current "
                "dataset; these splits are not valid for this data."
            )

    def get_split(
        self,
        run_index: int,
        all_subjects: Sequence[str],
        all_instances: Sequence[Instance],
        behaviors: Sequence[str],
        allow_relaxed_fallback: bool = False,
    ) -> Split:
        splits = self.manifest["splits"]
        if not 0 <= run_index < len(splits):
            raise IndexError(
                f"Run index {run_index} out of bounds for manifest with {len(splits)} splits."
            )
        entry = splits[run_index]
        return entry["train"], entry["validation"], entry["test"]


def write_split_manifest(
    path: str,
    splits: List[Dict[str, List[str]]],
    fingerprint: str,
    metadata: Dict[str, object] | None = None,
) -> None:
    """Write a fingerprinted splits.json manifest (used by the sweep runner)."""
    doc = {"dataset_fingerprint": fingerprint, "splits": splits}
    if metadata:
        doc.update(metadata)
    # mkstemp + rename like core/config.dump_yaml: a crash mid-dump must not
    # leave a truncated manifest (JSONDecodeError on the next load), and two
    # sweep runners racing on the same path must not interleave into one
    # shared '<path>.tmp' — each writer gets a unique tmp, last complete
    # manifest wins the rename.
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
