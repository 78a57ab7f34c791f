#!/usr/bin/env python3
"""Compare two checkouts of cbas_tpu_torch on one CUDA card, in one run.

    git archive <commit> | tar -x -C scratch_parent    # a gitignored directory
    python3 chip_ab.py --parent scratch_parent          # from the repository root

Runs the measurement four times, each in a fresh process that builds its
checkout's kernels: parent, change, change, parent (so drift in the card's
clocks or its host falls on both sides). Each run reads, ``--reads`` times
each:

- kernel ms (CUDA events over 20 launches after 3 warm-up) of K1 (flat),
  K2 (head-pair packed) and K3 (head-major) in bf16 at the main paths'
  shapes, with RoPE and without;
- warm encode frames/s: dinov3-vitb16 flat and packed (``CBAS_ATTN_FAT=0``)
  routes at 256x256 (batch 128) and 640x480 (batch 32); the DINOv3
  ViT-7B/16 width at depth 4 at 256x256 (batch 32) and 640x480 (batch 8).

Prints one JSON line per run, then a summary line: for each metric the
median and range of the parent's reads and of the change's, and the card's
name and power limit. Only the API both checkouts share is used. Needs one
GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

KERNEL_ROWS = (  # (entry, B, N, H, d, patch grid)
    ("attention_fat", 128, 261, 12, 64, (16, 16)),
    ("attention_fat", 32, 1205, 12, 64, (30, 40)),
    ("attention_packed", 128, 261, 12, 64, (16, 16)),
    ("attention_packed", 32, 1205, 12, 64, (30, 40)),
    ("attention_headmajor", 32, 261, 32, 128, (16, 16)),
    ("attention_headmajor", 8, 1205, 32, 128, (30, 40)),
)
VIT7B_CONFIG = {
    "model_type": "dinov3_vit", "hidden_size": 4096, "num_attention_heads": 32,
    "intermediate_size": 8192, "use_gated_mlp": True, "patch_size": 16,
    "num_register_tokens": 4, "rope_theta": 100.0, "layer_norm_eps": 1e-5,
    "num_hidden_layers": 4,
}


def card_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure(root: str, reads: int) -> dict:
    """Every metric of the checkout at ``root``, ``reads`` reads each."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import PRESETS
    from cbas_tpu_torch.ops import _cuda
    from cbas_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device is visible")
    t = time.perf_counter()
    for name in ("attention_fat", "attention_packed", "attention_headmajor"):
        _cuda.build(name)
    out = {"root": os.path.dirname(os.path.dirname(fa.__file__)), "build_s": time.perf_counter() - t}

    cfg = PRESETS["dinov3-vitb16"]
    wrappers = {"attention_fat": fa.fused_attention_fat,
                "attention_packed": fa.fused_attention_packed,
                "attention_headmajor": fa.fused_attention}
    rng = np.random.default_rng(0)
    for kernel, B, N, H, d, grid in KERNEL_ROWS:
        shape = {"attention_fat": (B, N, H * d), "attention_packed": (B, H // 2, N, 2 * d),
                 "attention_headmajor": (B, H, N, d)}[kernel]
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", torch.bfloat16)
                   for _ in range(3))
        cos, sin = chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda")
        for rope in (True, False):
            tables = (cos, sin) if rope else (None, None)
            fn = lambda: wrappers[kernel](q, k, v, d ** -0.5, None, *tables)  # noqa: E731
            out[f"{kernel} {B}x{N}x{H}x{d} rope={rope} ms"] = [
                chip_smoke.time_ms(torch, fn) for _ in range(reads)]
        del q, k, v

    def fps(enc, planes, batch, label):
        enc.encode_planes(planes[:batch], batch=batch)  # warm
        out[label] = [chip_smoke.warm_fps(torch, enc, planes, batch, 3) for _ in range(reads)]

    enc = FrameEncoder("dinov3-vitb16", random_init=True, device="cuda")
    planes_256 = rng.integers(0, 256, (128, 256, 256), np.uint8)
    planes_480 = rng.integers(0, 256, (32, 480, 640), np.uint8)
    fps(enc, planes_256, 128, "flat 256x256 fps")
    fps(enc, planes_480, 32, "flat 640x480 fps")
    os.environ["CBAS_ATTN_FAT"] = "0"
    fps(enc, planes_256, 128, "packed 256x256 fps")
    fps(enc, planes_480, 32, "packed 640x480 fps")
    del os.environ["CBAS_ATTN_FAT"]
    del enc
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(VIT7B_CONFIG, f)
        enc = FrameEncoder(ckpt, random_init=True, device="cuda")
        fps(enc, planes_256, 32, "vit7b-width depth 4 256x256 fps")
        fps(enc, planes_480, 8, "vit7b-width depth 4 640x480 fps")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent's checkout")
    ap.add_argument("--reads", type=int, default=3)
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one run, in the checkout at this root
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure), args.reads)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    here = os.path.dirname(os.path.abspath(__file__))
    card = card_name_and_power()
    print(card, flush=True)
    runs = []
    for side, root in (("parent", args.parent), ("change", here), ("change", here),
                       ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", os.path.abspath(root),
             "--reads", str(args.reads)],
            capture_output=True, text=True, cwd=os.path.abspath(root),
        )
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the {side} run failed ({proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["side"] = side
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {"card": card, "order": [r["side"] for r in runs], "metrics": {}}
    for key in runs[0]:
        if not isinstance(runs[0][key], list):
            continue
        for side in ("parent", "change"):
            reads = [x for r in runs if r["side"] == side for x in r[key]]
            summary["metrics"].setdefault(key, {})[side] = {
                "median": statistics.median(reads), "min": min(reads), "max": max(reads)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
