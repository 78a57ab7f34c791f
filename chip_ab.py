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
  shapes, with RoPE and without; K1 and K3 in fp32 at the fp32 main
  paths' four shapes (``runtime.compute_dtype: float32``: dinov3-vitb16's
  heads of 64 at 256x256 / 128 and 640x480 / 32, the ViT-7B width's heads
  of 128 at 32 and 8); and K3 at the widths no preset has: 192
  and 256 (16 heads at ViT-7B's batch), 160 and 200 (run at 192 and
  256) and, in bf16
  and fp32, 320 and 384 (the wide body); in fp32 also 16, 32, 136, 200
  and 256 (16 heads, N 261) and 192 and 256 (N 1205); in bf16 also 32,
  96 and 100 (N 261), 96, 100 and 150 (N 1205) and 65 (N 261: at an odd d
  with RoPE), 16 heads, the widths that K3's first bf16 body or a pad copy
  took before the staging pass; in bf16 at 640x480's 1205 tokens and 16
  heads also 160, 192, 200, 248 and 256, and at 261 tokens, 16 heads and
  batch 32 also 136 and 160: the widths the two-consumer body takes
  (``attention_sm90_ws.cuh``); each row with the SM clock, power and
  temperature after its reads (``chip_smoke.gpu_clocks``), and each bf16 K3
  row from 160 up with ``scaled_dot_product_attention``'s ms on the same
  tensors (RoPE applied beforehand, ``sdpa_ms``) beside it; tables of
  random angles where the model's rule builds none (d % 4 != 0,
  ``case_tables``);
- on a checkout that has it (the change's side), the two-consumer body as
  a timing case no route calls (``attention_variants.ws_attention``) at
  ``WS_ROWS``: built at 128 beside K3's one-warpgroup body at the ViT-7B
  width's two shapes, with RoPE and without;
- the head-major route's attention at the ViT-7B width (``ROUTE_ROWS``):
  views of flat projections in, K3, the context back as (B, N, H*d), with
  RoPE and without; a checkout whose K3 refuses views copies q, k, v and
  the context there, as its route did;
- a ``torch.profiler`` trace of K3 at ``TRACE_ROWS`` (the widths 160,
  192 and 256 at batch 32 and 192 at 1205 tokens, the width 160 run at 192
  and 192 itself at batch 8, and 100, a row of 200 bytes; with
  ``--kernels`` too): each CUDA kernel's
  launches and device ms per
  call, the device's busy ms per call, the host's ms to issue one call and
  the CUDA-event ms per call, read once (not a list, so not summarized);
- warm encode frames/s: dinov3-vitb16 flat and packed (``CBAS_ATTN_FAT=0``)
  routes at 256x256 (batch 128) and 640x480 (batch 32); the DINOv3
  ViT-7B/16 width at depth 4 at 256x256 (batch 32) and 640x480 (batch 8);
  the flat route and the ViT-7B width again in fp32 at the same batches
  (TF32 off in the GEMMs); and each of those forwards' ms a batch by CUDA
  events over 10 batches queued back to back (the host clock's frames/s
  spread more);
- a ``torch.profiler`` trace of one warm batch of each of those forwards
  (``trace_calls`` over 3 batches), its kernels summed by group
  (``KERNEL_GROUPS``: the LayerNorm kernel, attention, GEMMs, the rest) and
  its GEMMs by input shape, read once;
- on a checkout that has it (so on the change's side only), the LayerNorm
  kernel at ``LN_ROWS``: ms beside its plain version and the library call
  (``chip_smoke.ln_case``);
- K1, K2 and K3 in bf16 with RoPE on views of one fused (B, N, 3*H*d)
  q|k|v buffer at ``FUSED_ROWS`` (the operands the routes pass once the
  projection is one GEMM), beside the same call on contiguous tensors, on
  a checkout whose wrapper takes them (a K1 that refuses views records
  nothing; a parent's K2 and K3 take them but write the output with the
  views' strides, holes and all);
- on a checkout that has it, the memory floor at probe14's (384*6, 272,
  128) bf16 blocks and at ``FUSED_ROWS``' bytes, and ``out.copy_(q)`` there.

With ``--kernels`` each run reads only the kernel rows and the
two-consumer body's timing cases (a few minutes a run); ``--only B,N,H,d
...`` keeps only the kernel and timing rows of those shapes. ``--out PATH``
also writes every line to PATH, so a long summary line is kept whole.

With ``--widths`` each run reads only K3 in bf16 at ``WIDTH_ROWS`` (no
RoPE, contiguous): the call's ms by CUDA events and, from a
``torch.profiler`` trace, the device ms of each kernel it ran (the Hopper
body, and a staging pass where the checkout stages that width), so two
checkouts that read a width in place or through scratch compare kernel by
kernel (about 2 minutes a run).

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
from concurrent.futures import ThreadPoolExecutor

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
    ("attention_fat", 128, 261, 12, 64, (16, 16), "float32"),
    ("attention_fat", 32, 1205, 12, 64, (30, 40), "float32"),
    ("attention_headmajor", 32, 261, 32, 128, (16, 16), "float32"),
    ("attention_headmajor", 8, 1205, 32, 128, (30, 40), "float32"),
) + tuple(  # K3 in fp32 at widths no preset has
    ("attention_headmajor", B, N, 16, d, (16, 16) if N == 261 else (30, 40), "float32")
    for B, N, d in ((8, 261, 16), (8, 261, 32), (8, 261, 136), (8, 261, 200), (8, 261, 256),
                    (4, 1205, 192), (4, 1205, 256))
) + tuple(  # K3 in bf16 at the widths its first bf16 body or a pad copy took before staging
    ("attention_headmajor", B, N, 16, d, (16, 16) if N == 261 else (30, 40), "bfloat16")
    for B, N, d in ((8, 261, 32), (8, 261, 96), (8, 261, 100), (4, 1205, 96), (4, 1205, 100),
                    (4, 1205, 150), (8, 261, 65), (4, 1205, 160), (4, 1205, 192), (4, 1205, 200),
                    (4, 1205, 248), (4, 1205, 256), (32, 261, 136), (32, 261, 160)))
# The two-consumer body as a timing case (``attention_variants.ws_attention``),
# (B, N, H, d): at 128, where K3 runs the one-warpgroup body, at the ViT-7B
# width's shapes (RoPE on and off).
WS_ROWS = ((32, 261, 32, 128), (8, 1205, 32, 128))
# The head-major route's attention at the ViT-7B width, (B, N, H, d, patch
# grid), bf16: head-major views of flat (B, N, H*d) projections in, K3, the
# context back as (B, N, H*d). A checkout whose K3 refuses views runs its
# route as it did: q, k and v copied to contiguous tensors, the context
# copied back.
ROUTE_ROWS = ((32, 261, 32, 128, (16, 16)), (8, 1205, 32, 128, (30, 40)))
TRACE_ROWS = (  # (B, N, H, d, patch grid, RoPE), K3 in bf16
    (32, 261, 16, 160, (16, 16), False),
    (32, 261, 16, 192, (16, 16), False),
    (32, 261, 16, 256, (16, 16), False),
    (4, 1205, 16, 192, (30, 40), False),
    (8, 261, 16, 160, (16, 16), True),
    (8, 261, 16, 160, (16, 16), False),
    (8, 261, 16, 192, (16, 16), True),
    (8, 261, 16, 100, (16, 16), True),
    (8, 261, 16, 100, (16, 16), False),
)
TRACE_CALLS = 20
# The LayerNorm kernel's rows, (rows, D): dinov3-vitb16 at 256x256 batch 128
# and 640x480 batch 32, the ViT-7B width at 32 and 8; bf16, fused with the
# residual, single-pass (the main paths' form).
LN_ROWS = ((128 * 261, 768), (32 * 1205, 768), (32 * 261, 4096), (8 * 1205, 4096))
# A forward trace's kernels by group, the first pattern a name matches
# (lower case): the LayerNorm kernel, the attention kernels, cuBLAS's GEMMs
# (and CUTLASS's), the rest (elementwise, reductions, copies).
KERNEL_GROUPS = (("layernorm kernel", ("add_ln_",)), ("attention", ("attention",)),
                 ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")))
# K1, K2 and K3 on views of one fused projection, (entry, B, N, H, d, patch
# grid): dinov3-vitb16 at 256x256 / 128 and 640x480 / 32, and K3 at the
# ViT-7B width's 256x256 / 32.
FUSED_ROWS = (
    ("attention_fat", 128, 261, 12, 64, (16, 16)),
    ("attention_fat", 32, 1205, 12, 64, (30, 40)),
    ("attention_packed", 128, 261, 12, 64, (16, 16)),
    ("attention_headmajor", 128, 261, 12, 64, (16, 16)),
    ("attention_headmajor", 32, 261, 32, 128, (16, 16)),
)
# ``--widths``: K3 in bf16 at 640x480's 1205 tokens and 16 heads, at widths
# on both sides of the rows a tensor map reads whole 32-byte sectors of (d %
# 16 == 0) and of those it refuses (d % 8 != 0).
WIDTH_ROWS = tuple((4, 1205, 16, d) for d in (40, 64, 88, 96, 100, 104, 120, 128, 150, 152, 160,
                                             192, 200, 256))
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


def case_tables(torch, chip_smoke, cfg, d, grid, N):
    """(N, d) RoPE tables: the model's (``chip_smoke.rope_full``) where its
    rule builds them (d % 4 == 0), else cos and sin of random angles from a
    seed (``chip_smoke.head_tables``'s, which a parent may not have)."""
    import numpy as np

    if d % 4 == 0:
        return chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda")
    ang = np.random.default_rng(11).uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    return tuple(torch.from_numpy(f(ang)).to("cuda") for f in (np.cos, np.sin))


def sdpa_ms(torch, chip_smoke, q, k, v, scale, cos, sin) -> float:
    """``scaled_dot_product_attention``'s ms on q, k and v (head-major,
    contiguous), q and k roped beforehand in fp32 and rounded to their
    dtype where there are tables: the yardstick, timed as the kernels are."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if cos is not None:
        q, k = ((t.float() * cos + torch.cat([-t[..., t.shape[-1] // 2:],
                                               t[..., :t.shape[-1] // 2]], -1).float() * sin)
                .to(t.dtype) for t in (q, k))
    q, k, v = (t.contiguous() for t in (q, k, v))
    return chip_smoke.time_ms(torch, lambda: sdpa(q, k, v, scale=scale))


def trace_calls(torch, fn, calls: int = TRACE_CALLS) -> dict:
    """Where the time of one call of ``fn`` goes: ``calls`` calls under
    ``torch.profiler`` give each CUDA kernel's launches and device ms per
    call, each GEMM's (``aten::addmm`` and ``aten::mm``, by input shapes:
    one cuBLAS kernel name serves GEMMs of several shapes) and the device's
    busy ms per call; without the profiler, the host's ms to issue one call
    (no synchronize between calls) and the CUDA-event ms per call
    (``chip_smoke.time_ms``)."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    gemms = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::addmm", "aten::mm"):
            device_us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
            gemms[f"{e.key} {e.input_shapes}"] = {"calls_per_call": e.count / calls,
                                                  "device_ms_per_call": device_us / 1e3 / calls}
    kernels, api = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:90], {"launches_per_call": 0.0, "device_ms_per_call": 0.0})
            k["launches_per_call"] += 1 / calls
            k["device_ms_per_call"] += e.time_range.elapsed_us() / 1e3 / calls
        elif e.name.startswith("cu"):  # the CUDA runtime and driver calls the host made
            api[e.name] = api.get(e.name, 0) + 1 / calls
    return {"kernels": kernels, "runtime_calls_per_call": api, "gemms_by_shape": gemms,
            "device_busy_ms_per_call": sum(k["device_ms_per_call"] for k in kernels.values()),
            "host_issue_ms_per_call": issue_ms, "event_ms_per_call": chip_smoke.time_ms(torch, fn)}


def trace_groups(trace: dict) -> dict:
    """A ``trace_calls`` result summed by KERNEL_GROUPS: launches and device
    ms a call of each group, the busy and event ms, the 8 kernels that take
    the most device time, and each GEMM shape's calls and device ms."""
    groups = {name: {"launches_per_call": 0.0, "device_ms_per_call": 0.0}
              for name, _ in KERNEL_GROUPS + (("other", ()),)}
    for kernel, k in trace["kernels"].items():
        name = next((g for g, keys in KERNEL_GROUPS if any(x in kernel.lower() for x in keys)),
                    "other")
        for key in ("launches_per_call", "device_ms_per_call"):
            groups[name][key] += k[key]
    top = sorted(trace["kernels"].items(), key=lambda kv: -kv[1]["device_ms_per_call"])[:8]
    return {"groups": groups, "launches_per_call": sum(
                k["launches_per_call"] for k in trace["kernels"].values()),
            "device_busy_ms_per_call": trace["device_busy_ms_per_call"],
            "event_ms_per_call": trace["event_ms_per_call"],
            "host_issue_ms_per_call": trace["host_issue_ms_per_call"],
            "top_kernels": {name: k for name, k in top},
            "gemms_by_shape": trace["gemms_by_shape"]}


def measure(root: str, reads: int, kernels_only: bool = False, only=None) -> dict:
    """Every metric of the checkout at ``root``, ``reads`` reads each (with
    ``kernels_only``, KERNEL_ROWS and WS_ROWS alone; with ``only``, a set of
    (B, N, H, d), those of their rows alone)."""
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
    has_ln = os.path.exists(os.path.join(root, "cbas_tpu_torch", "csrc", "layernorm.cu"))
    extra = tuple(name for name in ("layernorm", "memory_floor")
                  if os.path.exists(os.path.join(root, "cbas_tpu_torch", "csrc", f"{name}.cu")))
    for name in ("attention_fat", "attention_packed", "attention_headmajor") + extra:
        _cuda.build(name)
    out = {"root": os.path.dirname(os.path.dirname(fa.__file__)), "build_s": time.perf_counter() - t}

    cfg = PRESETS["dinov3-vitb16"]
    wrappers = {"attention_fat": fa.fused_attention_fat,
                "attention_packed": fa.fused_attention_packed,
                "attention_headmajor": fa.fused_attention}
    rng = np.random.default_rng(0)
    for kernel, B, N, H, d, grid, dtype in KERNEL_ROWS:
        if only and (B, N, H, d) not in only:
            continue
        shape = {"attention_fat": (B, N, H * d), "attention_packed": (B, H // 2, N, 2 * d),
                 "attention_headmajor": (B, H, N, d)}[kernel]
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to("cuda", getattr(torch, dtype)) for _ in range(3))
        cos, sin = case_tables(torch, chip_smoke, cfg, d, grid, N)
        for rope in (True, False):
            pair = (cos, sin) if rope else (None, None)
            fn = lambda: wrappers[kernel](q, k, v, d ** -0.5, None, *pair)  # noqa: E731
            fp32 = " fp32" if dtype == "float32" else ""
            label = f"{kernel} {B}x{N}x{H}x{d} rope={rope}{fp32} ms"
            out[label] = [chip_smoke.time_ms(torch, fn) for _ in range(reads)]
            # the SM clock and power right after the reads
            out[label.replace(" ms", " gpu_clocks")] = chip_smoke.gpu_clocks()
            if kernel == "attention_headmajor" and not fp32 and d >= 160:
                out[label.replace(" ms", " sdpa_ms")] = [
                    sdpa_ms(torch, chip_smoke, q, k, v, d ** -0.5, *pair) for _ in range(reads)]
        del q, k, v
    ws_rows(torch, chip_smoke, cfg, rng, reads, out, only)
    for B, N, H, d, grid, rope in TRACE_ROWS:
        if only and (B, N, H, d) not in only:
            continue
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        pair = case_tables(torch, chip_smoke, cfg, d, grid, N) if rope else (None, None)
        out[f"trace attention_headmajor {B}x{N}x{H}x{d} rope={rope}"] = trace_calls(
            torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, *pair))  # noqa: B023
        del q, k, v
    if kernels_only:
        return out
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

    if has_ln:
        from cbas_tpu_torch.ops import layernorm as ln

        for rows, D in LN_ROWS:
            for key in ("ms", "plain_ms", "library_ms"):
                out[f"layernorm {rows}x{D} bf16 fused {key}"] = []
            for _ in range(reads):
                case = chip_smoke.ln_case(torch, ln, rows, D, "bfloat16", time_it=True)
                if not case["ok"]:
                    raise SystemExit(f"chip_ab: the LayerNorm kernel disagrees: {case}")
                for key in ("ms", "plain_ms", "library_ms"):
                    out[f"layernorm {rows}x{D} bf16 fused {key}"].append(case[key])
            out[f"layernorm {rows}x{D} bound ms"] = case["bound_ms"]

    for kernel, B, N, H, d, grid in FUSED_ROWS:
        qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(
            "cuda", torch.bfloat16)
        views = [qkv[..., j * H * d:(j + 1) * H * d] for j in range(3)]
        if kernel != "attention_fat":
            group = 2 if kernel == "attention_packed" else 1
            views = [t.view(B, N, H // group, group * d).transpose(1, 2) for t in views]
        copies = [t.contiguous() for t in views]
        tables = chip_smoke.rope_full(torch, cfg, d, grid, N, "cuda")
        try:
            wrappers[kernel](*views, d ** -0.5, None, *tables)
        except ValueError:  # a wrapper that takes contiguous tensors only
            continue
        for label, ops in (("fused views", views), ("contiguous", copies)):
            out[f"{kernel} {B}x{N}x{H}x{d} {label} rope=True ms"] = [
                chip_smoke.time_ms(torch, lambda ops=ops: wrappers[kernel](  # noqa: B023
                    *ops, d ** -0.5, None, *tables)) for _ in range(reads)]
        del qkv, views, copies
    if os.path.exists(os.path.join(root, "cbas_tpu_torch", "ops", "memory_floor.py")):
        from cbas_tpu_torch.ops import memory_floor as mf

        shapes = [(384 * 6, 272, 128)] + [(B * N, H * d) for _, B, N, H, d, _ in FUSED_ROWS]
        for shape in dict.fromkeys(shapes):
            q, k, v = chip_smoke.floor_inputs(torch, shape, "bfloat16")
            copy = torch.empty_like(q)
            label = "x".join(map(str, shape))
            out[f"memory floor {label} bf16 ms"] = [chip_smoke.time_ms(
                torch, lambda: mf.memory_floor(q, k, v)) for _ in range(reads)]  # noqa: B023
            out[f"copy_ {label} bf16 ms"] = [chip_smoke.time_ms(
                torch, lambda: copy.copy_(q)) for _ in range(reads)]  # noqa: B023
            del q, k, v, copy

    def fps(enc, planes, batch, label):
        enc.encode_planes(planes[:batch], batch=batch)  # warm
        out[label] = [chip_smoke.warm_fps(torch, enc, planes, batch, 3) for _ in range(reads)]
        # The same forward by CUDA events (no host clock, no copy back).
        out[label.replace("fps", "ms a batch (events)")] = [chip_smoke.time_ms(
            torch, lambda: enc.encode_planes_async(planes[:batch], batch=batch), iters=10)
            for _ in range(reads)]
        out[label.replace("fps", "trace of one batch")] = trace_groups(trace_calls(
            torch, lambda: enc.encode_planes_async(planes[:batch], batch=batch), calls=3))

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
    # fp32 forwards (runtime.compute_dtype: float32), full fp32 GEMMs.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc = FrameEncoder("dinov3-vitb16", random_init=True, compute_dtype=torch.float32,
                       device="cuda")
    fps(enc, planes_256, 128, "fp32 flat 256x256 fps")
    fps(enc, planes_480, 32, "fp32 flat 640x480 fps")
    del enc
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(VIT7B_CONFIG, f)
        enc = FrameEncoder(ckpt, random_init=True, device="cuda")
        fps(enc, planes_256, 32, "vit7b-width depth 4 256x256 fps")
        fps(enc, planes_480, 8, "vit7b-width depth 4 640x480 fps")
        del enc
        torch.cuda.empty_cache()
        enc = FrameEncoder(ckpt, random_init=True, compute_dtype=torch.float32, device="cuda")
        fps(enc, planes_256, 32, "fp32 vit7b-width depth 4 256x256 fps")
        fps(enc, planes_480, 8, "fp32 vit7b-width depth 4 640x480 fps")
    return out


def ws_rows(torch, chip_smoke, cfg, rng, reads, out, only=None) -> None:
    """The two-consumer body's timing cases at WS_ROWS (those in ``only``,
    where given) into ``out``, on a checkout whose ``attention_variants``
    has ``ws_attention``."""
    import numpy as np

    from cbas_tpu_torch.ops import attention_variants as av

    if not hasattr(av, "ws_attention"):
        return
    for B, N, H, d in WS_ROWS:
        if only and (B, N, H, d) not in only:
            continue
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        grid = (16, 16) if N == 261 else (30, 40)
        tables = case_tables(torch, chip_smoke, cfg, d, grid, N)
        for rope in (True, False):
            pair = tables if rope else (None, None)
            out[f"ws_attention {B}x{N}x{H}x{d} rope={rope} ms"] = [
                chip_smoke.time_ms(torch, lambda: av.ws_attention(  # noqa: B023
                    q, k, v, d ** -0.5, None, *pair)) for _ in range(reads)]  # noqa: B023
        out[f"ws_attention {B}x{N}x{H}x{d} gpu_clocks"] = chip_smoke.gpu_clocks()
        del q, k, v


def measure_widths(root: str, reads: int) -> dict:
    """K3 in bf16 at WIDTH_ROWS in the checkout at ``root``: the call's ms
    (``reads`` reads) and each kernel's device ms per call in one trace
    (``trace_calls``), keyed by the kernel's short name."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from cbas_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device is visible")
    out = {"root": os.path.dirname(os.path.dirname(fa.__file__))}
    rng = np.random.default_rng(0)
    for B, N, H, d in WIDTH_ROWS:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        label = f"width {B}x{N}x{H}x{d}"
        fn = lambda: fa.fused_attention(q, k, v, d ** -0.5)  # noqa: E731
        out[f"{label} ms"] = [chip_smoke.time_ms(torch, fn) for _ in range(reads)]
        for name, k_ in trace_calls(torch, fn)["kernels"].items():
            kind = "staging" if "stage_rows" in name else "body" if "attention" in name else "other"
            out.setdefault(f"{label} {kind} device ms", [0.0])[0] += k_["device_ms_per_call"]
        del q, k, v
    return out


def build_logs(root: str) -> dict:
    """Build every kernel of the checkout at ``root`` (one nvcc a source, in
    parallel, in a process of that checkout) and read each library's
    ``-Xptxas -v`` log: {library: log}."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "from cbas_tpu_torch.ops import _cuda\n"
        "names = sorted(p.stem for p in _cuda.SRC_DIR.glob('*.cu'))\n"
        "with ThreadPoolExecutor(len(names)) as pool:\n"
        "    libs = dict(zip(names, pool.map(_cuda.build, names)))\n"
        "print(json.dumps({n: l.with_suffix('.log').read_text() for n, l in libs.items()}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    if proc.returncode:
        raise SystemExit(f"building {root} failed:\n{proc.stderr[-8000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare_ptxas(parent: str, change: str) -> dict:
    """Registers, shared memory, stack and spills of every kernel that both
    checkouts' libraries hold, parent beside change: whether each is the
    same; and the kernels only the change has, and those only the parent
    has (a kernel the change no longer builds)."""
    with ThreadPoolExecutor(2) as pool:
        logs = dict(zip(("parent", "change"), pool.map(build_logs, (parent, change))))
    import chip_smoke

    def entries(log):  # (chip_smoke.ptxas_entries under chip_smoke.comparable_name)
        return {chip_smoke.comparable_name(name): e
                for name, e in chip_smoke.ptxas_entries(log).items()}

    kernels, only_change, only_parent = {}, {}, {}
    for lib, log in logs["change"].items():
        now = entries(log)
        before = entries(logs["parent"].get(lib, ""))
        for name, props in before.items():
            if name in now:
                kernels.setdefault(lib, {})[name] = {"parent": props, "change": now[name],
                                                     "same": props == now[name]}
        only_change[lib] = {name: props for name, props in now.items() if name not in before}
        only_parent[lib] = sorted(name for name in before if name not in now)
    return {"kernels": kernels, "only_in_change": only_change, "only_in_parent": only_parent,
            "missing_in_change": sorted(set(logs["parent"]) - set(logs["change"])),
            "all_same": all(k["same"] for lib in kernels.values() for k in lib.values())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent's checkout")
    ap.add_argument("--reads", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true",
                    help="compare the two checkouts' ptxas reports only (no card needed)")
    ap.add_argument("--widths", action="store_true",
                    help="read K3 in bf16 at WIDTH_ROWS only, kernel by kernel")
    ap.add_argument("--kernels", action="store_true",
                    help="read KERNEL_ROWS and WS_ROWS only")
    ap.add_argument("--only", nargs="+", default=None, metavar="B,N,H,d",
                    help="with --kernels: only the rows of these shapes")
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--measure", help=argparse.SUPPRESS)  # one run, in the checkout at this root
    args = ap.parse_args()
    if args.measure:
        root = os.path.abspath(args.measure)
        only = {tuple(int(x) for x in shape.split(",")) for shape in args.only or ()}
        run = measure_widths(root, args.reads) if args.widths else measure(
            root, args.reads, args.kernels, only)
        print(json.dumps(run), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    here = os.path.dirname(os.path.abspath(__file__))
    if args.ptxas:
        print(json.dumps(compare_ptxas(os.path.abspath(args.parent), here)), flush=True)
        return 0
    card = card_name_and_power()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w") if args.out else None

    def say(line):
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    say(card)
    runs = []
    for side, root in (("parent", args.parent), ("change", here), ("change", here),
                       ("parent", args.parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", os.path.abspath(root),
             "--reads", str(args.reads)] + (["--widths"] if args.widths else [])
            + (["--kernels"] if args.kernels else [])
            + (["--only", *args.only] if args.only else []),
            capture_output=True, text=True, cwd=os.path.abspath(root),
        )
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the {side} run failed ({proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["side"] = side
        say(json.dumps(run))
        runs.append(run)
    summary = {"card": card, "order": [r["side"] for r in runs], "metrics": {}}
    keys = list(dict.fromkeys(key for r in runs for key in r))
    for key in keys:
        for side in ("parent", "change"):
            reads = [x for r in runs if r["side"] == side and isinstance(r.get(key), list)
                     for x in r[key]]
            if reads:
                summary["metrics"].setdefault(key, {})[side] = {
                    "median": statistics.median(reads), "min": min(reads), "max": max(reads)}
    say(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
