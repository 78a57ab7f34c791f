"""Filename conventions shared across the framework.

Copy of ``cbas_tpu/utils/naming.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

These encode the on-disk contract inherited from the reference project layout
(reference: ProjectDirectory.md, backend/cbas.py:409,471,679-711): every video
``<stem>.mp4`` may have a sibling embedding file ``<stem>_cls.h5`` and per-model
probability tables ``<stem>_<model>_outputs.csv``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

H5_SUFFIX = "_cls.h5"
OUTPUTS_SUFFIX = "_outputs.csv"


def h5_path_for_video(video_path: str) -> str:
    return os.path.splitext(video_path)[0] + H5_SUFFIX


def video_path_for_h5(h5_path: str) -> str:
    assert h5_path.endswith(H5_SUFFIX), h5_path
    return h5_path[: -len(H5_SUFFIX)] + ".mp4"


def outputs_csv_for_h5(h5_path: str, model_name: str) -> str:
    assert h5_path.endswith(H5_SUFFIX), h5_path
    # suffix arithmetic, not str.replace: the token may also appear inside a
    # directory component of the path
    return h5_path[: -len(H5_SUFFIX)] + f"_{model_name}{OUTPUTS_SUFFIX}"


def outputs_csv_is_stale(csv_path: str, model_dir: str) -> bool:
    """True when ``csv_path`` must be re-inferred before its predictions can
    be trusted as coming from the model currently saved in ``model_dir``.

    The rule (shared by guided labeling and the disagreement report): a CSV
    older than the bundle's saved weights was written by the PREVIOUS model
    of the same name and would masquerade as the current one. Weights mtime
    is the newest of ``model.npz``/``model.pth`` — pth-only bundles (imported
    reference artifacts, core/project.py Model fallback) must trigger the
    same staleness. With no weights file at all the CSV is trusted; a CSV
    that vanishes between the existence check and ``getmtime`` is stale (the
    re-infer rewrites it).
    """
    if not os.path.exists(csv_path):
        return True
    weight_mtimes = []
    for fname in ("model.npz", "model.pth"):
        try:
            weight_mtimes.append(os.path.getmtime(os.path.join(model_dir, fname)))
        except OSError:
            pass
    if not weight_mtimes:
        return False  # no saved weights to compare: trust the CSV
    try:
        return os.path.getmtime(csv_path) < max(weight_mtimes)
    except OSError:
        return True  # csv vanished under us: re-infer


_FP_CACHE: dict = {}


def _checkpoint_fingerprint(path: str, legacy: bool = False) -> Optional[str]:
    """Content fingerprint of a local checkpoint dir/file: sha256 over the
    file name + size plus a strided sample (head, middle, tail) of each file's
    bytes, so an in-place weights swap with unchanged early tensors (frozen
    patch embeddings etc.) still changes the fingerprint. Stable across
    machines (content-based); cached per (realpath, mtime).

    ``legacy=True`` reproduces the pre-strided algorithm (head 64 KiB only)
    so stamps written by earlier releases still validate — without it, a
    version upgrade would re-fingerprint every unchanged local checkpoint and
    silently queue a full re-encode of the video library."""
    import hashlib

    try:
        real = os.path.realpath(path)
        if os.path.isdir(real):
            files = [os.path.join(real, "config.json")] + [
                os.path.join(real, n)
                for n in ("model.safetensors", "pytorch_model.bin", "model.pth")
            ]
        else:
            files = [real]
        files = [f for f in files if os.path.isfile(f)]
        if not files:
            return None
        cache_key = (real, legacy)
        key = (real, tuple(os.path.getmtime(f) for f in files))
        hit = _FP_CACHE.get(cache_key)
        if hit and hit[0] == key:
            return hit[1]
        h = hashlib.sha256()
        window = 65536
        for f in files:
            size = os.path.getsize(f)
            h.update(os.path.basename(f).encode())
            h.update(str(size).encode())
            with open(f, "rb") as fh:
                h.update(fh.read(window))
                if not legacy:
                    if size > 2 * window:
                        fh.seek((size - window) // 2)
                        h.update(fh.read(window))
                    if size > window:
                        fh.seek(max(size - window, window))
                        h.update(fh.read(window))
        fp = h.hexdigest()[:8]
        _FP_CACHE[cache_key] = (key, fp)
        return fp
    except OSError:
        return None


def canonical_encoder_identity(identifier: str) -> str:
    """Machine-independent identity of an encoder identifier.

    HF-style ids ("facebook/dinov3-vitb16") are their own identity. Local
    checkpoint paths reduce to ``basename#<content-fingerprint>`` so H5
    stamps and model-bundle encoder guards written on one machine still match
    after the project moves (a project-local encoder resolves to a different
    absolute path on every host — see core/project.py
    encoder_model_identifier), while two *different* checkpoints that merely
    share a directory name still mismatch (forcing the safe re-encode rather
    than silently running a head on foreign embeddings). *Absolute* foreign
    paths that don't exist locally reduce to the bare basename — never equal
    to a fingerprinted local identity, so the mismatch path (re-encode) wins.
    A *relative* separator-containing identifier that doesn't exist locally
    is returned verbatim: it is indistinguishable from an HF-style id
    ("facebook/dinov3-vitb16"), and returning it unchanged also fails safe
    (a stamp mismatch forces re-encode, never a silent match).

    Note the exact rule: a separator-containing identifier is treated as a
    filesystem path only when it *exists locally* (isdir/isfile) or is
    absolute. A relative separator-containing identifier that does not exist
    here (e.g. a foreign "subdir/enc") is returned verbatim — it can never be
    reduced to a fingerprinted identity without the bytes, so it always
    mismatches and forces the safe re-encode. The existence check cannot be
    dropped: HF-style ids ("facebook/dinov3-vitb16") contain "/" and must not
    be interpreted as paths."""
    s = identifier.rstrip("/\\")
    # Bare names (old stamps, canonical identities like "demo_encoder#ab12")
    # must never be re-interpreted against the CWD — only absolute paths and
    # separator-containing relative paths are treated as filesystem locations.
    looks_like_path = os.path.isabs(s) or (
        (os.sep in s or "/" in s) and (os.path.isdir(s) or os.path.isfile(s))
    )
    if looks_like_path:
        base = os.path.basename(s)
        fp = _checkpoint_fingerprint(s)
        return f"{base}#{fp}" if fp else base
    return s


def encoder_identity_candidates(identifier: str) -> tuple:
    """All identities this identifier may legitimately appear stamped as.

    The primary (current-algorithm) identity first, then the legacy
    head-only-hash identity for local checkpoints — so embeddings stamped by
    an earlier release keep validating after an upgrade instead of queueing
    a full library re-encode. New stamps are always written with the primary
    identity (EmbeddingWriter uses :func:`canonical_encoder_identity`)."""
    primary = canonical_encoder_identity(identifier)
    out = [primary]
    if "#" in primary:
        s = identifier.rstrip("/\\")
        legacy_fp = _checkpoint_fingerprint(s, legacy=True)
        if legacy_fp:
            legacy = f"{os.path.basename(s)}#{legacy_fp}"
            if legacy != primary:
                out.append(legacy)
    return tuple(out)


def identities_equivalent(a: str, b: str) -> bool:
    """True iff two encoder identifiers denote the same checkpoint, accepting
    either side's legacy-fingerprint form."""
    ca, cb = encoder_identity_candidates(a), encoder_identity_candidates(b)
    return not set(ca).isdisjoint(cb)


def outputs_csv_for_video(video_path: str, model_name: str) -> str:
    return os.path.splitext(video_path)[0] + f"_{model_name}{OUTPUTS_SUFFIX}"


def video_for_outputs_csv(csv_path: str, model_name: str) -> str:
    suffix = f"_{model_name}{OUTPUTS_SUFFIX}"
    assert csv_path.endswith(suffix), csv_path
    return csv_path[: -len(suffix)] + ".mp4"


STAGING_SUFFIX = ".tmp.mp4"


def is_staging_artifact(path: str) -> bool:
    """True for in-progress standardize/augment outputs (``*.tmp.mp4``).

    These are atomic-write staging files (ingest/standardize.py) that a
    crash can orphan inside the recordings tree; scanners and watchers must
    never treat them as real recordings (they would surface phantom videos
    and queue corrupt partials for encode at every project load).
    """
    return os.path.basename(path).endswith(STAGING_SUFFIX)


_SEGMENT_RE = re.compile(r"_(\d+)(?:_aug)?\.mp4$")


def segment_index(video_path: str) -> int:
    """Numeric segment suffix of a recorded video file, or -1 if unnumbered.

    Recorded segments are named ``<camera>_%05d.mp4`` (reference:
    backend/cbas.py:686-689); augmented siblings carry an ``_aug`` suffix.
    """
    m = _SEGMENT_RE.search(os.path.basename(video_path))
    return int(m.group(1)) if m else -1


def sort_videos_by_segment(paths: list[str]) -> list[str]:
    return sorted(paths, key=segment_index)


def natural_sort_outputs(paths: list[str], model_name: str) -> list[str]:
    """Sort per-segment output CSVs in recording order.

    Mirrors the natural-sort-by-segment used when stitching actogram input CSVs
    (reference: backend/cbas.py:982-986).
    """
    rx = re.compile(r"_(\d+)_" + re.escape(model_name))

    def key(p: str) -> Optional[int]:
        m = rx.search(os.path.basename(p))
        return int(m.group(1)) if m else None

    if all(key(p) is not None for p in paths):
        return sorted(paths, key=key)
    return sorted(paths)
