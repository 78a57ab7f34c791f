"""Weak scaling of the data-parallel encode: step time at a fixed batch per
device as the mesh widens.

Counterpart of ``cbas_tpu/tools/weak_scaling.py``. Each width n times
``FrameEncoder.encode_planes`` over a data mesh of n shards at
``per_device_batch`` frames a shard, and reports ``overhead_pct``: how much
slower one weak-scaled step is than n serial steps of one device (the
embarrassingly parallel ideal when the shards share the hardware; the
encode batch is independent frames and the weights are replicated, so
nothing but the split and the gather is added). On distinct cards a step
should instead take about as long at every width.

The port's mesh runs in one process (one thread a shard), so no child
processes are needed: on CUDA the widths are the first n visible cards (a
width needing more cards than are visible raises); with ``--device cpu``
they are n logical shards of the CPU, which share its cores.

Run: python -m cbas_tpu_torch.tools.weak_scaling [--devices 1 2 4 8] [--device cpu]
Writes JSON to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from cbas_tpu_torch.tools._device import require_device

# A 4-block ViT-S-width encoder (hidden 384, 6 heads of 64, MLP 1536) on
# 64x64 planes, random weights from seed 0: the JAX tool's model.
WIDTH = dict(variant="dinov3", hidden_size=384, num_layers=4, num_heads=6, patch_size=16,
             num_register_tokens=4, intermediate_size=1536, layer_norm_eps=1e-5)
PLANE = 64


def measure(n: int, per_device_batch: int, iters: int, device="cuda") -> dict:
    """Mean step time of the DP encode over ``n`` shards (one device, no
    mesh, at n = 1): wall seconds (``step_s``) and the process's CPU
    seconds, every thread's (``cpu_step_s``: on logical CPU shards the cost
    of the work itself, which the scheduler's delays on busy cores leave
    out)."""
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import ViTConfig, init_vit_params
    from cbas_tpu_torch.parallel.mesh import make_mesh

    dev = require_device(device)
    if dev.type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} devices asked for, {torch.cuda.device_count()} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [dev] * n
    cfg = ViTConfig(**WIDTH)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    kw = dict(params=init_vit_params(0, cfg), cfg=cfg, compute_dtype=dtype)
    enc = (FrameEncoder("ws", mesh=make_mesh(devices=devices), **kw) if n > 1
           else FrameEncoder("ws", device=devices[0], **kw))
    batch = per_device_batch * n
    planes = np.random.default_rng(0).integers(0, 256, (batch, PLANE, PLANE), np.uint8)
    enc.encode_planes(planes)  # warm: geometry state, kernel builds
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(iters):
        enc.encode_planes(planes)  # ends in a device-to-host copy
    dt = (time.perf_counter() - t0) / iters
    return {"devices": n, "device": str(devices[0]), "batch": batch, "step_s": dt,
            "cpu_step_s": (time.process_time() - c0) / iters, "frames_per_s_total": batch / dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--per-device-batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="distinct CUDA cards (default) or logical shards of the CPU")
    args = ap.parse_args(argv)

    rows = []
    for n in args.devices:
        rows.append(measure(n, args.per_device_batch, args.iters, args.device))
        print(f"[weak-scaling] {rows[-1]}", file=sys.stderr)
    base = rows[0]
    for r in rows:
        # the serial ideal on shared hardware: n single-device steps
        ideal = base["step_s"] * r["devices"] / base["devices"]
        r["overhead_pct"] = 100.0 * (r["step_s"] - ideal) / ideal
    note = ("distinct CUDA cards: a step should take about as long at every width; "
            "overhead_pct is against the serial ideal" if args.device == "cuda" else
            "logical CPU shards share the cores: total throughput is core-bound; "
            "overhead_pct against the serial ideal is the signal")
    print(json.dumps({"per_device_batch": args.per_device_batch, "rows": rows, "note": note},
                     indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
