"""Fleet encode: fan a video library out over every local CUDA device.

The app's encode path runs one batch on one device; for a
*library* of independent videos — the actual CBAS backfill workload, e.g.
re-encoding a month of recordings after an encoder upgrade — whole-file
parallelism wins: each card runs its own FrameEncoder process at full batch
size with no cross-card synchronization at all (the reference has no
equivalent; its one GPU encodes serially, backend/workthreads.py:201-300).

    python -m cbas_tpu_torch.tools.encode_fleet --project /path/to/project [--workers N]
    python -m cbas_tpu_torch.tools.encode_fleet --project ... --model NAME   # classify

``--model NAME`` switches to classify mode: the same fan-out runs an
InferenceSession per card over every embedding H5 lacking the model's
outputs CSV (the app's start_classification rule), CSVs written tmp+rename.

Architecture (one parent, N single-card workers):

- The parent scans the project for stale/missing embeddings (same rule as
  the app's startup sweep: H5 absent, unstamped, or stamped by a different
  encoder) and writes the todo list to a manifest. It never creates a CUDA
  context; without a CUDA device (and no ``--force-cpu``) it exits 2.
- Each worker binds one card (``CUDA_VISIBLE_DEVICES=<i>``, set before torch
  import), builds one FrameEncoder, and drains the manifest; with
  ``--force-cpu`` the workers run on the CPU.
- Work is distributed by an ATOMIC CLAIM, not a queue: a worker owns a video
  iff it created ``<h5>.claim`` with O_CREAT|O_EXCL. Claims are plain files
  on the filesystem the recordings live on, so the same manifest can be
  drained by workers on *other hosts* of a pod sharing that filesystem —
  multi-host fan-out with zero coordination infrastructure. Claims older
  than ``--claim-ttl`` are presumed dead (crashed worker) and broken.
- Output H5s are written via the engine's tmp+rename path, so a killed
  worker never leaves a half-written embedding file, and the claim file is
  what makes retry safe.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional


def _emit(obj: dict) -> None:
    """One ATOMIC stdout write per record: workers share the parent's pipe,
    and POSIX only guarantees non-interleaved pipe writes for a single
    write() under PIPE_BUF — print()'s text layer may split the newline off
    into a second syscall, shearing concurrent workers' lines together."""
    os.write(sys.stdout.fileno(), (json.dumps(obj) + "\n").encode())


def scan_todo(project_path: str) -> List[str]:
    """Videos needing (re-)encode, by the app's own staleness rule."""
    from cbas_tpu_torch.core.project import Project

    return Project(project_path).stale_or_missing_embeddings()


def scan_classify_todo(proj, model_name: str) -> List[str]:
    """Embedding H5s lacking ``model_name``'s outputs CSV (the same rule as
    Api.start_classification, app/workers.py — incl. skipping augmentation
    siblings, whose predictions nothing consumes, and treating CSVs older
    than the bundle's saved weights as missing so a same-name retrain
    re-runs the fleet instead of keeping the previous model's predictions)."""
    from cbas_tpu_torch.ingest.standardize import is_aug_video
    from cbas_tpu_torch.utils.naming import (
        h5_path_for_video,
        outputs_csv_for_h5,
        outputs_csv_is_stale,
    )

    model = proj.models.get(model_name)
    model_dir = model.path if model else ""

    todo = []
    for video in proj.all_video_files():
        if is_aug_video(video):
            continue
        h5 = h5_path_for_video(video)
        if not os.path.exists(h5):
            continue
        csv = outputs_csv_for_h5(h5, model_name)
        stale = (
            outputs_csv_is_stale(csv, model_dir)
            if model_dir
            else not os.path.exists(csv)
        )
        if stale:
            todo.append(h5)
    return todo


# ---------------------------------------------------------------------------
# claim protocol
# ---------------------------------------------------------------------------

def claim_path(item: str, model: Optional[str] = None) -> str:
    """Claim file sits next to the item's OUTPUT (encode: the video's H5;
    classify: the H5's outputs CSV), on the same filesystem."""
    if model:
        from cbas_tpu_torch.utils.naming import outputs_csv_for_h5

        return outputs_csv_for_h5(item, model) + ".claim"
    from cbas_tpu_torch.utils.naming import h5_path_for_video

    return h5_path_for_video(item) + ".claim"


def try_claim(item: str, ttl_s: float, model: Optional[str] = None) -> bool:
    """Atomically claim ``item``; True iff this process now owns it
    (utils/claims.py holds the lease protocol)."""
    from cbas_tpu_torch.utils.claims import try_claim_path

    return try_claim_path(claim_path(item, model), ttl_s)


def release_claim(item: str, model: Optional[str] = None) -> None:
    from cbas_tpu_torch.utils.claims import release_claim_path

    release_claim_path(claim_path(item, model))


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

def run_worker(manifest: str, encoder_path: str, chip: Optional[int],
               force_cpu: bool, claim_ttl: float, batch: int,
               model_dir: Optional[str] = None,
               project_path: Optional[str] = None) -> int:
    """Drain the manifest on one card. Prints one JSON line per file."""
    if chip is not None and not force_cpu:
        # must precede any CUDA initialization in this process; assign
        # (not setdefault) — a leftover CUDA_VISIBLE_DEVICES in the operator's
        # shell would otherwise bind every worker to the same card and
        # silently collapse the fan-out
        os.environ["CUDA_VISIBLE_DEVICES"] = str(chip)

    from cbas_tpu_torch.tools._device import require_device

    device = require_device("cpu" if force_cpu else "cuda", "--force-cpu")

    if model_dir:
        return _run_classify_worker(manifest, encoder_path, model_dir, claim_ttl, device)

    from cbas_tpu_torch.core import hdf5_store
    from cbas_tpu_torch.core.config import EncodeConfig
    from cbas_tpu_torch.engine.encode import EncodeStats, encode_file
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.utils.claims import ClaimHeartbeat
    from cbas_tpu_torch.utils.naming import h5_path_for_video

    videos = json.load(open(manifest))
    # project encode settings (e.g. reuse_threshold) apply here too;
    # an explicit --batch overrides the chunk size
    cfg = EncodeConfig()
    dtype = "bfloat16"
    if project_path:
        from cbas_tpu_torch.core.project import Project

        settings = Project(project_path).settings
        cfg = settings.encode
        dtype = settings.runtime.compute_dtype  # the encoder's dtype, as in the app
    import torch

    enc = FrameEncoder(encoder_path, device=device, compute_dtype=getattr(torch, dtype))
    if batch:
        import dataclasses

        cfg = dataclasses.replace(cfg, chunk_frames=batch)
    done = failed = 0
    for video in videos:
        # The claim is a LEASE (who is encoding now), not a done-marker: the
        # stamp on the finished H5 is the done-marker. Check it first, or a
        # worker arriving after a peer finished+released would re-encode.
        h5 = h5_path_for_video(video)
        if os.path.exists(h5) and hdf5_store.is_stamp_valid(h5, encoder_path):
            continue
        if not try_claim(video, claim_ttl):
            continue
        # re-check under the lease: the previous owner may have finished
        # between our stamp check and our claim
        if os.path.exists(h5) and hdf5_store.is_stamp_valid(h5, encoder_path):
            release_claim(video)
            continue
        try:
            st = EncodeStats()
            # Heartbeat the lease: a single video longer than the TTL must
            # not have its LIVE claim broken mid-encode (a second worker
            # would truncate the same <h5>.tmp under this one).
            with ClaimHeartbeat(claim_path(video), claim_ttl):
                out = encode_file(enc, video, config=cfg, stats=st)
            if out is None:
                # encode_file declined (empty/corrupt video): no H5 was
                # written, so counting it done would contradict the parent's
                # post-run staleness scan. Keep the claim for the retry TTL.
                failed += 1
                _emit({"video": video, "error": "no output (empty or undecodable video)"})
                continue
            done += 1
            _emit({"video": video, "h5": out, "fps": round(st.fps, 1),
                   "frames": st.frames})
        except Exception as e:  # keep draining; the claim stays for retry TTL
            failed += 1
            _emit({"video": video, "error": f"{type(e).__name__}: {e}"})
            continue
        release_claim(video)
    _emit({"worker_done": True, "encoded": done, "failed": failed})
    return 0 if failed == 0 else 1


def _run_classify_worker(manifest: str, encoder_path: str, model_dir: str,
                         claim_ttl: float, device) -> int:
    """Classify mode: drain a manifest of embedding H5s through one
    InferenceSession. The outputs CSV is the done-marker; infer_h5 itself
    writes tmp+rename, so a killed worker never leaves a partial CSV that
    reads as done."""
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.utils.claims import ClaimHeartbeat
    from cbas_tpu_torch.utils.naming import outputs_csv_for_h5, outputs_csv_is_stale

    bundle = ClassifierBundle.load(model_dir, expected_encoder=encoder_path)
    session = InferenceSession(bundle, device=device)
    model = bundle.name
    done = failed = 0
    for h5 in json.load(open(manifest)):
        csv = outputs_csv_for_h5(h5, model)
        # Skip by the SAME rule the parent scan used (outputs_csv_is_stale),
        # not bare existence: after a same-name retrain every stale CSV is in
        # the manifest precisely because it exists but presents the previous
        # model's predictions — an existence check would skip all of them.
        if not outputs_csv_is_stale(csv, model_dir):
            continue
        if not try_claim(h5, claim_ttl, model=model):
            continue
        # finished by the prior lease holder
        if not outputs_csv_is_stale(csv, model_dir):
            release_claim(h5, model=model)
            continue
        try:
            t0 = time.time()
            with ClaimHeartbeat(claim_path(h5, model), claim_ttl):
                out = session.infer_h5(h5, output_csv=csv)
            if not out:
                # infer_h5 declined (empty H5): no CSV exists, so the item
                # stays todo — report it as a failure, not a success.
                failed += 1
                _emit({"h5": h5, "error": "no output (empty embedding file)"})
                continue
            done += 1
            _emit({"h5": h5, "csv": csv, "wall_s": round(time.time() - t0, 2)})
        except Exception as e:
            failed += 1
            _emit({"h5": h5, "error": f"{type(e).__name__}: {e}"})
            continue
        release_claim(h5, model=model)
    _emit({"worker_done": True, "classified": done, "failed": failed})
    return 0 if failed == 0 else 1


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--project", required=True)
    ap.add_argument("--workers", type=int, default=0,
                    help="default: one per local CUDA device")
    ap.add_argument("--claim-ttl", type=float, default=3600.0,
                    help="seconds before another worker may break a claim")
    ap.add_argument("--batch", type=int, default=0,
                    help="override EncodeConfig.chunk_frames")
    ap.add_argument("--force-cpu", action="store_true",
                    help="run workers on the CPU (tests/dev)")
    ap.add_argument("--manifest", default=None,
                    help="drain an existing manifest instead of scanning "
                         "(multi-host: scan on one host, share the file)")
    ap.add_argument("--model", default=None,
                    help="classify mode: run this model over every embedding "
                         "H5 lacking its outputs CSV (instead of encoding)")
    # internal: child mode
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--chip", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--encoder", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--model-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        return run_worker(args.manifest, args.encoder, args.chip,
                          args.force_cpu, args.claim_ttl, args.batch,
                          model_dir=args.model_dir,
                          project_path=args.project)

    from cbas_tpu_torch.core.project import Project

    proj = Project(args.project)
    encoder = proj.encoder_model_identifier
    model_dir = None
    if args.model:
        model = proj.models.get(args.model)
        if model is None:
            _emit({"error": f"model '{args.model}' not found in project"})
            return 2
        model_dir = model.path
    if args.manifest:
        manifest = args.manifest
        todo = json.load(open(manifest))
    else:
        todo = (scan_classify_todo(proj, args.model) if args.model
                else scan_todo(args.project))
        manifest = os.path.join(args.project, f".encode_fleet_{os.getpid()}.json")
        with open(manifest, "w") as f:
            json.dump(todo, f)
    if not todo:
        _emit({"fleet_done": True, "videos": 0, "workers": 0})
        return 0

    n = args.workers
    if not args.force_cpu:
        try:  # count cards WITHOUT creating a CUDA context in this process
            out = subprocess.run(
                [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
                capture_output=True, text=True, timeout=120,
            )
            cards = int(out.stdout.strip().splitlines()[-1])
        except (subprocess.SubprocessError, ValueError, IndexError):
            cards = 0
        if cards == 0:
            _emit({"error": "no CUDA device is visible; pass --force-cpu to run the "
                            "workers on the CPU"})
            if not args.manifest:
                os.unlink(manifest)
            return 2
        if n <= 0:
            n = cards
    n = min(max(n, 1), len(todo))

    cmd_base = [sys.executable, "-m", "cbas_tpu_torch.tools.encode_fleet",
                "--project", args.project, "--worker", "--manifest", manifest,
                "--encoder", encoder, "--claim-ttl", str(args.claim_ttl),
                "--batch", str(args.batch)]
    if model_dir:
        cmd_base += ["--model-dir", model_dir]
    if args.force_cpu:
        cmd_base.append("--force-cpu")
    t0 = time.time()
    procs = [subprocess.Popen(cmd_base + ["--chip", str(i)]) for i in range(n)]
    codes = [p.wait() for p in procs]
    # Signal-killed workers exit NEGATIVE (-9 for an OOM SIGKILL), which a
    # max() would mask behind a healthy worker's 0 — any nonzero code means
    # part of the library may not have been drained.
    rc = 0 if not any(codes) else 1
    wall = time.time() - t0

    if args.manifest:
        remaining = None
    elif args.model:
        remaining = scan_classify_todo(Project(args.project), args.model)
    else:
        remaining = scan_todo(args.project)
    summary = {"fleet_done": True, "videos": len(todo), "workers": n,
               "wall_s": round(wall, 1), "rc": rc, "worker_rcs": codes}
    if remaining is not None:
        summary["still_stale"] = len(remaining)
    _emit(summary)
    if not args.manifest:
        try:
            os.unlink(manifest)
        except OSError:
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())
