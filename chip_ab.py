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
  shapes, with RoPE and without; and K3 at the widths no preset has: 192
  and 256 (16 heads at ViT-7B's batch), 160 and 200 (run at 192 and
  256) and, in bf16
  and fp32, 320 and 384 (the wide body);
- the head-major route's attention at the ViT-7B width (``ROUTE_ROWS``):
  views of flat projections in, K3, the context back as (B, N, H*d), with
  RoPE and without; a checkout whose K3 refuses views copies q, k, v and
  the context there, as its route did;
- a ``torch.profiler`` trace of K3 at ``TRACE_ROWS`` (the width 160 run
  at 192, and 192 itself): each CUDA kernel's launches and device ms per
  call, the device's busy ms per call, the host's ms to issue one call and
  the CUDA-event ms per call, read once (not a list, so not summarized);
- warm encode frames/s: dinov3-vitb16 flat and packed (``CBAS_ATTN_FAT=0``)
  routes at 256x256 (batch 128) and 640x480 (batch 32); the DINOv3
  ViT-7B/16 width at depth 4 at 256x256 (batch 32) and 640x480 (batch 8);
  and each of those forwards' ms a batch by CUDA events over 10 batches
  queued back to back (the host clock's frames/s spread more).

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

KERNEL_ROWS = (  # (entry, B, N, H, d, patch grid, dtype)
    ("attention_fat", 128, 261, 12, 64, (16, 16), "bfloat16"),
    ("attention_fat", 32, 1205, 12, 64, (30, 40), "bfloat16"),
    ("attention_packed", 128, 261, 12, 64, (16, 16), "bfloat16"),
    ("attention_packed", 32, 1205, 12, 64, (30, 40), "bfloat16"),
    ("attention_headmajor", 32, 261, 32, 128, (16, 16), "bfloat16"),
    ("attention_headmajor", 8, 1205, 32, 128, (30, 40), "bfloat16"),
    ("attention_headmajor", 32, 261, 16, 192, (16, 16), "bfloat16"),
    ("attention_headmajor", 32, 261, 16, 256, (16, 16), "bfloat16"),
    ("attention_headmajor", 8, 261, 16, 160, (16, 16), "bfloat16"),
    ("attention_headmajor", 8, 261, 16, 200, (16, 16), "bfloat16"),
    ("attention_headmajor", 8, 261, 16, 320, (16, 16), "bfloat16"),
    ("attention_headmajor", 4, 1205, 8, 384, (30, 40), "bfloat16"),
    ("attention_headmajor", 8, 261, 16, 320, (16, 16), "float32"),
    ("attention_headmajor", 4, 1205, 8, 384, (30, 40), "float32"),
)
# The head-major route's attention at the ViT-7B width, (B, N, H, d, patch
# grid), bf16: head-major views of flat (B, N, H*d) projections in, K3, the
# context back as (B, N, H*d). A checkout whose K3 refuses views runs its
# route as it did: q, k and v copied to contiguous tensors, the context
# copied back.
ROUTE_ROWS = ((32, 261, 32, 128, (16, 16)), (8, 1205, 32, 128, (30, 40)))
TRACE_ROWS = (  # (B, N, H, d, patch grid, RoPE), K3 in bf16
    (8, 261, 16, 160, (16, 16), True),
    (8, 261, 16, 160, (16, 16), False),
    (8, 261, 16, 192, (16, 16), True),
)
TRACE_CALLS = 20
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


def trace_calls(torch, fn, calls: int = TRACE_CALLS) -> dict:
    """Where the time of one call of ``fn`` goes: ``calls`` calls under
    ``torch.profiler`` give each CUDA kernel's launches and device ms per
    call and the device's busy ms per call; without the profiler, the host's
    ms to issue one call (no synchronize between calls) and the CUDA-event
    ms per call (``chip_smoke.time_ms``)."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    issue_ms = 1e3 * (time.perf_counter() - t) / calls
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, api = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:90], {"launches_per_call": 0.0, "device_ms_per_call": 0.0})
            k["launches_per_call"] += 1 / calls
            k["device_ms_per_call"] += e.time_range.elapsed_us() / 1e3 / calls
        elif e.name.startswith("cu"):  # the CUDA runtime and driver calls the host made
            api[e.name] = api.get(e.name, 0) + 1 / calls
    return {"kernels": kernels, "runtime_calls_per_call": api,
            "device_busy_ms_per_call": sum(k["device_ms_per_call"] for k in kernels.values()),
            "host_issue_ms_per_call": issue_ms, "event_ms_per_call": chip_smoke.time_ms(torch, fn)}


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
    for kernel, B, N, H, d, grid, dtype in KERNEL_ROWS:
        shape = {"attention_fat": (B, N, H * d), "attention_packed": (B, H // 2, N, 2 * d),
                 "attention_headmajor": (B, H, N, d)}[kernel]
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to("cuda", getattr(torch, dtype)) for _ in range(3))
        cos, sin = chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda")
        for rope in (True, False):
            tables = (cos, sin) if rope else (None, None)
            fn = lambda: wrappers[kernel](q, k, v, d ** -0.5, None, *tables)  # noqa: E731
            fp32 = " fp32" if dtype == "float32" else ""
            label = f"{kernel} {B}x{N}x{H}x{d} rope={rope}{fp32} ms"
            out[label] = [chip_smoke.time_ms(torch, fn) for _ in range(reads)]
        del q, k, v
    for B, N, H, d, grid in ROUTE_ROWS:
        flat = [torch.from_numpy(rng.standard_normal((B, N, H * d), np.float32))
                .to("cuda", torch.bfloat16) for _ in range(3)]
        views = [t.view(B, N, H, d).transpose(1, 2) for t in flat]
        try:
            fa.fused_attention(*views, d ** -0.5)
            copies = False
        except ValueError:  # a K3 that takes contiguous tensors only
            copies = True
        cos, sin = chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda")

        def route(tables, views=views, copies=copies, B=B, N=N, H=H, d=d):
            operands = [t.contiguous() for t in views] if copies else views
            ctx = fa.fused_attention(*operands, d ** -0.5, None, *tables)
            return ctx.transpose(1, 2).reshape(B, N, H * d)

        for rope in (True, False):
            tables = (cos, sin) if rope else (None, None)
            label = f"K3 route (views in, context out) {B}x{N}x{H}x{d} rope={rope} ms"
            out[label] = [chip_smoke.time_ms(torch, lambda: route(tables))  # noqa: B023
                          for _ in range(reads)]
        out[f"K3 route {B}x{N}x{H}x{d} copies q, k, v and the context"] = copies
        del flat, views
    for B, N, H, d, grid, rope in TRACE_ROWS:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        tables = chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda") if rope else (None, None)
        out[f"trace attention_headmajor {B}x{N}x{H}x{d} rope={rope}"] = trace_calls(
            torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, *tables))  # noqa: B023
        del q, k, v

    def fps(enc, planes, batch, label):
        enc.encode_planes(planes[:batch], batch=batch)  # warm
        out[label] = [chip_smoke.warm_fps(torch, enc, planes, batch, 3) for _ in range(reads)]
        # The same forward by CUDA events (no host clock, no copy back).
        out[label.replace("fps", "ms a batch (events)")] = [chip_smoke.time_ms(
            torch, lambda: enc.encode_planes_async(planes[:batch], batch=batch), iters=10)
            for _ in range(reads)]

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
