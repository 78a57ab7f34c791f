#!/usr/bin/env python3
"""Drive cbas_tpu_torch's serving paths once on a CUDA card and check them.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, one JSON line each (a failed check raises, so the script exits
non-zero and prints no final line):

1. environment: torch/CUDA versions, the card's name and power limit, and a
   fresh build of every kernel from ``cbas_tpu_torch/csrc`` (one nvcc per
   source, started together), with each kernel's registers and spills;
2. kernel: each fused attention against its plain PyTorch version on the
   card, bf16 and fp32, RoPE on and off, N = 261 and 1205, ``n_valid`` < N
   (272 / 261 and 1216 / 1205) with NaN in the dead K/V rows, and the main
   paths' shapes:
   - K1 (flat) at dinov3-vitb16's 12 heads;
   - K2 (head-pair packed) at its 6 pairs, on contiguous tensors and on
     head-pair views of flat ones (the packed route's operands);
   - K3 (head-major) at 32 heads of 128 (DINOv3 ViT-7B), at 3 heads of 64
     (an odd head count), and at head dims 96 and 40.
   bf16 at head dims 64 and 128 runs the Hopper body (``attention_body``),
   the rest the common body. At the main shapes (K2: on both inputs) each
   kernel is timed with RoPE and without, beside its plain version, its
   bound (FLOP and bytes over the card's peaks) and
   ``scaled_dot_product_attention`` on the same data (head-major, RoPE
   applied beforehand; the backend it picked is named by its kernels in a
   profiler trace);
3. encode, flat route: the main path at the full width of dinov3-vitb16
   (random weights from a numpy seed): 256x256 planes in two full batches
   and a partial one, 640x480 planes in one batch, then the head over the
   embeddings. Kernel launch counts are read around this run: K1 only, each
   through the Hopper body. Then
   warm frames/s, and accuracy against the port's CPU fp32 run on the same
   weights;
4. classify: probabilities of a deltas head (seq_len 31) against the CPU run;
5. encode, packed route: ``CBAS_ATTN_FAT=0``, one 256x256 batch and one
   640x480 batch through dinov3-vitb16: K2 only, on views of the
   projections, each through the Hopper body; embeddings against the flat
   route's;
6. encode, ViT-7B width: a checkpoint directory whose ``config.json`` has
   DINOv3 ViT-7B/16's published shape with the depth cut, opened through
   ``FrameEncoder``: 256x256 in a full batch and a partial one, 640x480 in
   one batch: K3 only, each through the Hopper body. Warm frames/s, and
   accuracy against the CPU fp32 run;
7. files: ``encode_file`` -> ``infer_h5`` on a synthetic clip, then
   ``run_training_job`` on a two-subject project built from encoded clips
   and ``infer_h5`` with the bundle it wrote, where h5py, pandas, OpenCV,
   yaml, matplotlib and scikit-learn are installed (otherwise a line says
   what is missing);
8. train: the deltas head at the app's default width on synthetic
   embeddings served from memory through ``WindowSource``: one train step
   on the card against the CPU (TF32 off), ``train_head`` on the
   device-resident store (torch's TF32 defaults, as a user runs it), warm
   steps/s and epoch seconds, then the trained params as a bundle saved,
   loaded and run by ``InferenceSession``, and ``fit_temperature``.

The line before the last lists each kernel with its launches on its route,
error, times, bound and the library call's time; the last line is
``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ENCODER = "dinov3-vitb16"
SEED = 0
BATCH_256 = 128                 # device batch at 256x256
FRAMES_256 = 2 * BATCH_256 + 40  # two full batches and a partial one
BATCH_480 = 32                  # one 640x480 batch
N_CHECK_256, N_CHECK_480 = 4, 2  # frames held against the CPU fp32 run
SEQ_LEN, HIDDEN, BEHAVIORS = 31, 64, ["a", "b"]

# DINOv3 ViT-7B/16 (arXiv:2508.10104; facebook/dinov3-vit7b16-pretrain-lvd1689m's
# config.json): full width, depth cut from 40 to 4 blocks, because a numpy
# init of all 40 is 27 GB of fp32 on the host. Random weights from SEED.
VIT7B_CONFIG = {
    "model_type": "dinov3_vit", "hidden_size": 4096, "num_attention_heads": 32,
    "intermediate_size": 8192, "use_gated_mlp": True, "patch_size": 16,
    "num_register_tokens": 4, "rope_theta": 100.0, "layer_norm_eps": 1e-5,
}
VIT7B_DEPTH, VIT7B_PUBLISHED_DEPTH = 4, 40
BATCH_7B_256, FRAMES_7B_256 = 32, 40  # one full batch and a partial one
BATCH_7B_480 = 8
N_CHECK_7B = 2

# The three kernels (source cbas_tpu_torch/csrc/<name>.cu) and the TPU kernel
# each replaces.
# The card's peaks (NVIDIA's H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its FLOP over the bf16 tensor-core rate and its
# bytes (each input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
KERNELS = {
    "attention_fat": "cbas_tpu/ops/flash_attention.py:553",
    "attention_packed": "cbas_tpu/ops/flash_attention.py:101",
    "attention_headmajor": "cbas_tpu/ops/flash_attention.py:35",
}

# Tolerances, each with its reason:
# - kernel fp32: both sides compute in fp32 and differ only in summation
#   order; the JAX suite's own bound.
KERNEL_FP32_TOL = 2e-5
# - kernel bf16: both sides round at the same points (roped q and k, p
#   before p.V, the output), but the kernel rounds each p against a running
#   max, so each p may differ by two bf16 roundings (2 * 2^-9) and the output
#   by 2^-8 of the largest |v|, plus one bf16 ulp of the output and a floor
#   for summation order.
KERNEL_BF16_VREL = 2.0 ** -8
KERNEL_BF16_FLOOR = 1e-5
# - encode fp32 (GPU kernel vs CPU plain, fp16 output): the fp32 values
#   differ only by summation order, so the fp16 store may round them one
#   ulp apart; near zero that ulp is below the fp32 error of the O(1) terms
#   summed over the layers, hence an absolute floor on top.
ENCODE_FP32_ULPS = 1
ENCODE_FP32_FLOOR = 1e-4
# - encode bf16 vs CPU fp32: the layers' bf16 rounding and tanh GELU;
#   per-row cosine. The packed route against the flat one is held to the
#   same bound (both are bf16 runs of the same weights).
ENCODE_BF16_MIN_COS = 0.99
# - classify: fp32 on both devices (TF32 off), summation order only.
CLASSIFY_TOL = 1e-4

# 8. Training at the app's defaults (cbas_tpu/core/config.py:132-156):
# dinov3-vitb16 embeddings (768), seq_len 31, biLSTM hidden 64, batch 512,
# the three-stream head. 16 synthetic recordings, each one 30-minute segment
# at 10 fps (18,000 frames x 768 fp16, 442 MB in all), laid out as
# contiguous bouts of 4 behaviours; 12 train and 4 held out for validation,
# 5,000 labelled centres each (60,000 for training).
TRAIN_RECORDINGS, TRAIN_VAL_RECORDINGS, TRAIN_FRAMES = 16, 4, 18_000
TRAIN_LABELLED = 5_000
TRAIN_BEHAVIORS = ["rear", "groom", "walk", "rest"]
TRAIN_BOUTS = (50, 400)   # bout lengths in frames, uniform
TRAIN_CLASS_SPREAD = 0.08  # each class mean is N(0, spread^2) a dim; noise N(0, 1)
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR = 512, 3, 1e-3
TRAIN_TIMED_STEPS = 50
# - one train step, card vs CPU, fp32 with TF32 off: summation order only,
#   through cuDNN's LSTM and cuBLAS against the CPU's kernels. The loss
#   within 1e-5 relative. Each gradient within 1e-4 of its tensor's largest
#   |g| (ten times the CPU tests' bound against JAX: the card may split the
#   15,872-row weight reductions differently), plus 1e-6 of the largest |g|
#   in the head: attention_head.bias has no gradient (the softmax over the
#   centre window ignores a shift of every score), so both devices give
#   rounding noise there. Each updated weight within 1e-6 plus
#   lr (|dg| + u) / (min |g + wd p| + eps): Adam's first step moves a weight
#   by lr g' / (|g'| + eps), g' the decayed gradient g + wd p, which changes
#   by at most that much when g' moves by |dg| plus u, one fp32 ulp of
#   |g| + |wd p| for the rounding of the sum on each device.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_FLOOR = 1e-5, 1e-4, 1e-6
STEP_WEIGHT_DECAY, GATE_DECAY = 1e-2, 1e-3
# - learning: validation weighted F1 after TRAIN_EPOCHS epochs. The same
#   phase on the CPU clears it with margin (PERF.md, training).
TRAIN_MIN_F1 = 0.9
# - the trained bundle through InferenceSession against build_logits_program
#   on the same windows, both fp32 on the card with TF32 off.
SERVE_TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def build_all(_cuda) -> dict:
    """Build every kernel's library at once (one nvcc each, in parallel);
    returns {name: (library path, seconds)}."""
    def one(name):
        t = time.perf_counter()
        return name, (_cuda.build(name), time.perf_counter() - t)

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(pool.map(one, KERNELS))


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log, as
    "<dtype><head dim>: N regs, S/L spill" strings."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(attention_bf16|attention_f32|attention_sm90|rope_rows)ILi(\d+)E"
                          r"(?:Li(\d+)E)?", m.group(1))
            args = ", ".join(x for x in k.groups()[1:] if x) if k else ""
            name = f"{k.group(1).replace('attention_', '')}<{args}>" if k else m.group(1)
            spill = "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill} spill")
            name = None
    return out


def rope_full(torch, cfg, head_dim, grid, n_tokens, device):
    """Full-length (n_tokens, head_dim) RoPE tables as the model builds them
    for ``cfg``'s theta and a ``head_dim``-wide head: identity prefix rows,
    then the patch grid, then zero pad rows."""
    from cbas_tpu_torch.models.vit import rope_tables

    cfg = dataclasses.replace(cfg, hidden_size=head_dim * cfg.num_heads)
    cos, sin = (torch.from_numpy(t) for t in rope_tables(cfg, *grid))
    p = cfg.num_prefix_tokens
    pad = n_tokens - p - cos.shape[0]
    cos = torch.cat([torch.ones(p, head_dim), cos, torch.zeros(pad, head_dim)])
    sin = torch.cat([torch.zeros(p, head_dim), sin, torch.zeros(pad, head_dim)])
    return cos.to(device), sin.to(device)


def kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype, rope, n_valid=None,
                time_it=True, view=False):
    """One fused-attention case on the card against its plain version, in
    the kernel's own layout; with ``view`` (K2 only), on head-pair views of
    flat (B, N, H*d) tensors, as the packed route passes them."""
    wrapper, plain, shape, token_dim = {
        "attention_fat": (fa.fused_attention_fat, fa.attention_fat_reference, (B, N, H * d), 1),
        "attention_packed": (
            fa.fused_attention_packed, fa.attention_packed_reference, (B, H // 2, N, 2 * d), 2,
        ),
        "attention_headmajor": (
            fa.fused_attention, fa.attention_headmajor_reference, (B, H, N, d), 2,
        ),
    }[kernel]
    rng = np.random.default_rng(SEED)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((B, N, H * d) if view else shape, np.float32))
        .to("cuda", dtype) for _ in range(3)
    )
    if view:
        q, k, v = (t.view(B, N, H // 2, 2 * d).transpose(1, 2) for t in (q, k, v))
    if n_valid is not None:  # dead rows hold NaN: the masks must keep it out
        dead = (slice(None),) * token_dim + (slice(n_valid, None),)
        k[dead] = float("nan")
        v[dead] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = rope_full(torch, cfg, d, grid, N, "cuda")
    scale = d ** -0.5
    got = wrapper(q, k, v, scale, n_valid, cos, sin)
    want = plain(q, k, v, scale, n_valid, cos, sin)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tol = KERNEL_FP32_TOL * (1 + want.float().abs())
        tol_text = f"{KERNEL_FP32_TOL} abs + rel"
    else:
        live = (slice(None),) * token_dim + (slice(0, n_valid or N),)
        vmax = float(v[live].float().abs().max())
        tol = bf16_ulp(torch, want.float()) + KERNEL_BF16_VREL * vmax + KERNEL_BF16_FLOOR
        tol_text = f"1 bf16 ulp + 2^-8 max|v| ({KERNEL_BF16_VREL * vmax:.3g}) + {KERNEL_BF16_FLOOR}"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    out = {
        "phase": "kernel", "name": kernel, "body": fa.attention_body(kernel, dtype, d),
        "inputs": "views of flat tensors" if view else "contiguous",
        "B": B, "N": N, "H": H, "head_dim": d,
        "dtype": str(dtype).replace("torch.", ""), "rope": rope, "n_valid": n_valid,
        "max_abs_err": float(err.max()), "tol": tol_text, "ok": ok,
    }
    if time_it:
        out["ms"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid, cos, sin))
        out["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, scale, n_valid, cos, sin))
        out["ms_norope"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid))
        out.update(attention_bound(B, N, H, d, n_valid or N, rope))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        heads = {"attention_fat": lambda t: t.reshape(B, N, H, d).transpose(1, 2),
                 "attention_packed": lambda t: t.reshape(B, H // 2, N, 2, d).transpose(2, 3)
                 .reshape(B, H, N, d),
                 "attention_headmajor": lambda t: t}[kernel]
        out["library_ms"], out["library_kernels"] = library_case(
            torch, fa, heads(q), heads(k), heads(v), scale, cos, sin)
        out["library"] = sdpa_backend(out["library_kernels"])
    return out


def attention_bound(B, N, H, d, n_valid, rope) -> dict:
    """The least time the card could take for one fused attention in bf16:
    q.k^T and p.V over the live keys on the tensor cores, against q and o
    (N rows), k and v (n_valid rows) and the fp32 RoPE tables moved once."""
    flop = 4 * B * H * N * n_valid * d
    nbytes = 2 * B * H * d * (2 * N + 2 * n_valid) + (2 * N * d * 4 if rope else 0)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"gflop": flop / 1e9, "mbytes": nbytes / 1e6, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def library_case(torch, fa, q, k, v, scale, cos, sin):
    """``scaled_dot_product_attention`` on head-major (B, H, N, d) copies of
    the inputs, contiguous, with RoPE applied beforehand (fp32, rounded to
    the input dtype) and the scale passed in: (ms, the CUDA kernels one call
    ran). The port never calls it; it is the yardstick only."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if cos is not None:
        q, k = ((t.float() * cos + fa.rotate_half(t.float()) * sin).to(t.dtype) for t in (q, k))
    q, k, v = (t.contiguous() for t in (q, k, v))
    ms = time_ms(torch, lambda: sdpa(q, k, v, scale=scale))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(q, k, v, scale=scale)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0})
    return ms, names


def sdpa_backend(kernels) -> str:
    """SDPA's backend, named from the kernels it ran."""
    text = " ".join(kernels).lower()
    for key, name in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                      ("cutlass", "efficient")):
        if key in text:
            return name
    return "math" if kernels else "unknown (no device events traced)"


def kernel_phase(torch, fa, cfg) -> dict:
    """Every kernel case; returns the main-shape cases of each kernel,
    {name: (256x256 case, 640x480 case)} (the ``kernels`` line's numbers)."""
    g256, g480 = (16, 16), (30, 40)  # patch grids of 256x256 and 640x480
    bf16, f32 = torch.bfloat16, torch.float32
    results, main = [], {}

    def sweep(kernel, H, d, small=((4, 261, g256), (2, 1205, g480)), ropes=(False, True),
              dead=((4, 272, 261, g256), (2, 1216, 1205, g480)), views=(False,)):
        for view in views:
            for B, N, grid in small:
                for dtype in (bf16, f32):
                    for rope in ropes:
                        results.append(kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype,
                                                   rope, view=view))
            for B, N, n_valid, grid in dead:  # NaN in the dead rows
                for dtype in (bf16, f32):
                    for rope in ropes:
                        results.append(kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype,
                                                   rope, n_valid=n_valid, view=view))

    H = cfg.num_heads
    sweep("attention_fat", H, 64)
    sweep("attention_packed", H, 64, views=(False, True))
    sweep("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128,
          small=((2, 261, g256), (1, 1205, g480)),
          dead=((2, 272, 261, g256), (1, 1216, 1205, g480)))
    sweep("attention_headmajor", 3, 64)  # an odd head count
    for d in (96, 40):  # a half that is no power of two; a dim no multiple of 16
        sweep("attention_headmajor", 4, d, small=((2, 261, g256),), ropes=(True,),
              dead=((4, 272, 261, g256),))
    # The main paths' shapes: ViT-B at batch 128 / 32, ViT-7B width at 32 / 8.
    # K2 on contiguous tensors here; on views (its route's inputs) below.
    for kernel, H, d, b256, b480 in (
        ("attention_fat", H, 64, BATCH_256, BATCH_480),
        ("attention_packed", H, 64, BATCH_256, BATCH_480),
        ("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128, BATCH_7B_256,
         BATCH_7B_480),
    ):
        main[kernel] = (
            kernel_case(torch, fa, cfg, kernel, b256, H, 261, d, g256, bf16, True),
            kernel_case(torch, fa, cfg, kernel, b480, H, 1205, d, g480, bf16, True),
        )
        results += main[kernel]
    main["attention_packed"] = tuple(
        kernel_case(torch, fa, cfg, "attention_packed", b, cfg.num_heads, n, 64, g, bf16, True,
                    view=True)
        for b, n, g in ((BATCH_256, 261, g256), (BATCH_480, 1205, g480)))
    results += main["attention_packed"]
    for r in results:
        emit(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused attention disagrees with its plain version: {bad}")
    return main


def reset_launches(fa) -> None:
    fa.launches = fa.launches_packed = fa.launches_headmajor = fa.launches_sm90 = 0


def read_launches(fa) -> dict:
    """Launches of each entry, and under "sm90" those that ran the Hopper body."""
    return {"attention_fat": fa.launches, "attention_packed": fa.launches_packed,
            "attention_headmajor": fa.launches_headmajor, "sm90": fa.launches_sm90}


def check_launches(route, got, kernel, per_forward, forwards, sm90) -> dict:
    """The route launched ``kernel`` ``per_forward`` times a forward, and no
    other kernel; each launch through the Hopper body if ``sm90``, else none."""
    want = {name: 0 for name in KERNELS}
    want[kernel] = per_forward * forwards
    want["sm90"] = want[kernel] if sm90 else 0
    if got != want:
        raise AssertionError(f"{route} route launched {got}, expected {want}")
    return want


@contextlib.contextmanager
def env_var(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def encode_stream(enc, planes, batch):
    """Encode ``planes`` in device batches the way ``encode_file`` does: one
    batch in flight while the next is queued. Returns (embeddings, forwards)."""
    out, in_flight, forwards = [], None, 0
    for start in range(0, len(planes), batch):
        pending = enc.encode_planes_async(planes[start:start + batch], batch=batch)
        forwards += 1
        if in_flight is not None:
            out.append(enc.to_host(in_flight))
        in_flight = pending
    out.append(enc.to_host(in_flight))
    return np.concatenate(out), forwards


def warm_fps(torch, enc, planes, batch, reps):
    enc.encode_planes(planes[:batch], batch=batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        enc.encode_planes(planes[:batch], batch=batch)
    return reps * batch / (time.perf_counter() - t0)


def row_cosine(a, b):
    a, b = a.astype(np.float32), b.astype(np.float32)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def accuracy_check(cpu, gpu32, planes, e_bf16, n, name, extra=None) -> dict:
    """The GPU fp32 run within 1 fp16 ulp + floor of the CPU fp32 run, and
    the bf16 embeddings within the cosine bound of it."""
    ref = cpu.encode_planes(planes[:n]).astype(np.float32)
    g32 = gpu32.encode_planes(planes[:n]).astype(np.float32)
    err = np.abs(g32 - ref)
    ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
    cos = row_cosine(e_bf16[:n], ref)
    ok = bool(
        (err <= ENCODE_FP32_ULPS * ulp + ENCODE_FP32_FLOOR).all()
        and cos.min() >= ENCODE_BF16_MIN_COS
    )
    line = {
        "phase": "encode_accuracy", "geometry": name, "frames": n, **(extra or {}),
        "fp32_max_abs_err": float(err.max()), "fp32_max_fp16_ulps": float((err / ulp).max()),
        "fp32_tol": f"{ENCODE_FP32_ULPS} fp16 ulp + {ENCODE_FP32_FLOOR}",
        "bf16_min_cos": float(cos.min()), "bf16_tol_min_cos": ENCODE_BF16_MIN_COS,
        "ok": ok,
    }
    emit(line)
    if not ok:
        raise AssertionError(f"encode at {name} disagrees with the CPU fp32 run")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run.", file=sys.stderr)
        return 2
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params
    from cbas_tpu_torch.models.vit import PRESETS, init_vit_params
    from cbas_tpu_torch.ops import _cuda
    from cbas_tpu_torch.ops import flash_attention as fa

    # fp32 references run in full fp32: cuDNN (the LSTM) defaults to TF32.
    # Training runs as a user runs it, with torch's defaults.
    user_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment and build
    card = card_name_and_power()
    print(card, flush=True)
    t = time.perf_counter()
    libs = build_all(_cuda)
    emit({
        "phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "card": card,
        "device": torch.cuda.get_device_name(0), "build_s": time.perf_counter() - t,
        "build_s_each": {name: s for name, (_, s) in libs.items()},
        "ptxas": {name: ptxas_report(lib.with_suffix(".log").read_text())
                  for name, (lib, _) in libs.items()},
    })

    # 2. the kernels against their plain versions
    cfg = PRESETS[ENCODER]
    main_cases = kernel_phase(torch, fa, cfg)

    # 3 + 4. the flat route: encode at full width, then classify
    params = init_vit_params(SEED, cfg)
    enc = FrameEncoder(ENCODER, random_init=True, device="cuda")
    rng = np.random.default_rng(SEED)
    planes_256 = rng.integers(0, 256, (FRAMES_256, 256, 256), np.uint8)
    planes_480 = rng.integers(0, 256, (BATCH_480, 480, 640), np.uint8)
    head_cfg = DeltasHeadConfig(
        in_features=cfg.hidden_size, out_features=len(BEHAVIORS), seq_len=SEQ_LEN,
        lstm_hidden_size=HIDDEN,
    )
    bundle = ClassifierBundle(
        name="smoke", behaviors=BEHAVIORS, seq_len=SEQ_LEN,
        params=init_deltas_params(SEED, head_cfg), lstm_hidden_size=HIDDEN,
        encoder_identifier=enc.identifier,
    )
    session = InferenceSession(bundle, device="cuda")
    half = SEQ_LEN // 2
    per_forward = cfg.num_layers - 1  # the CLS-only last block is plain

    torch.cuda.synchronize()
    reset_launches(fa)
    t = time.perf_counter()
    emb_256, fwd_256 = encode_stream(enc, planes_256, BATCH_256)
    emb_480, fwd_480 = encode_stream(enc, planes_480, BATCH_480)
    probs = session.predict_frames(emb_256, pad_front=half, pad_back=half)
    main_s = time.perf_counter() - t
    flat_launches = read_launches(fa)
    forwards = fwd_256 + fwd_480
    want_flat = check_launches("flat", flat_launches, "attention_fat", per_forward, forwards,
                               sm90=True)
    for name, e, n in (("256x256", emb_256, FRAMES_256), ("640x480", emb_480, BATCH_480)):
        if e.shape != (n, cfg.hidden_size) or e.dtype != np.float16 or not np.isfinite(e).all():
            raise AssertionError(f"{name} embeddings: {e.shape} {e.dtype}, finite={np.isfinite(e).all()}")

    emit({
        "phase": "encode", "route": "flat (K1)", "encoder": ENCODER, "dtype": "bfloat16",
        "frames_256": FRAMES_256, "batch_256": BATCH_256, "frames_480": BATCH_480,
        "forwards": forwards, "launches": flat_launches, "expected_launches": want_flat,
        "main_path_s": main_s,
        "warm_fps_256": warm_fps(torch, enc, planes_256, BATCH_256, 4),
        "warm_fps_480": warm_fps(torch, enc, planes_480, BATCH_480, 3),
        "card": card,
    })

    # Accuracy against the port's CPU fp32 run on the same weights.
    cpu = FrameEncoder(ENCODER, params=params, compute_dtype=torch.float32, device="cpu")
    gpu32 = FrameEncoder(ENCODER, params=params, compute_dtype=torch.float32, device="cuda")
    accuracy_check(cpu, gpu32, planes_256, emb_256, N_CHECK_256, "256x256")
    accuracy_check(cpu, gpu32, planes_480, emb_480, N_CHECK_480, "640x480")
    del cpu, gpu32

    # 4. classify check
    ref_probs = InferenceSession(bundle, device="cpu").predict_frames(
        emb_256, pad_front=half, pad_back=half
    )
    err = float(np.abs(probs - ref_probs).max())
    ok = (
        probs.shape == (FRAMES_256, len(BEHAVIORS)) and bool(np.isfinite(probs).all())
        and float(np.abs(probs.sum(1) - 1).max()) <= 1e-5 and err <= CLASSIFY_TOL
    )
    emit({
        "phase": "classify", "frames": FRAMES_256, "shape": list(probs.shape),
        "max_row_sum_err": float(np.abs(probs.sum(1) - 1).max()),
        "max_abs_err_vs_cpu": err, "tol": CLASSIFY_TOL, "ok": ok,
    })
    if not ok:
        raise AssertionError("classify probabilities disagree with the CPU run")

    # 5. the packed route: the same encoder and planes with the flat layout off
    with env_var("CBAS_ATTN_FAT", "0"):
        torch.cuda.synchronize()
        reset_launches(fa)
        t = time.perf_counter()
        pk_256, pf_256 = encode_stream(enc, planes_256[:BATCH_256], BATCH_256)
        pk_480, pf_480 = encode_stream(enc, planes_480, BATCH_480)
        packed_s = time.perf_counter() - t
        packed_launches = read_launches(fa)
        want_packed = check_launches(
            "packed", packed_launches, "attention_packed", per_forward, pf_256 + pf_480, sm90=True
        )
        cos_256 = row_cosine(pk_256, emb_256[:BATCH_256])
        cos_480 = row_cosine(pk_480, emb_480)
        ok = bool(
            np.isfinite(pk_256).all() and np.isfinite(pk_480).all()
            and min(cos_256.min(), cos_480.min()) >= ENCODE_BF16_MIN_COS
        )
        emit({
            "phase": "encode_packed", "route": "packed (K2), CBAS_ATTN_FAT=0",
            "encoder": ENCODER, "dtype": "bfloat16", "frames_256": BATCH_256,
            "frames_480": BATCH_480, "forwards": pf_256 + pf_480,
            "launches": packed_launches, "expected_launches": want_packed,
            "main_path_s": packed_s,
            "min_cos_vs_flat_256": float(cos_256.min()),
            "min_cos_vs_flat_480": float(cos_480.min()),
            "max_abs_diff_vs_flat": float(max(
                np.abs(pk_256.astype(np.float32) - emb_256[:BATCH_256]).max(),
                np.abs(pk_480.astype(np.float32) - emb_480).max(),
            )),
            "tol_min_cos": ENCODE_BF16_MIN_COS,
            "warm_fps_256": warm_fps(torch, enc, planes_256, BATCH_256, 4),
            "warm_fps_480": warm_fps(torch, enc, planes_480, BATCH_480, 3),
            "card": card, "ok": ok,
        })
        if not ok:
            raise AssertionError("the packed route's embeddings disagree with the flat route's")

    # 6. the ViT-7B-width encode through K3
    vit7b_launches, vit7b_line = vit7b_phase(torch, fa, FrameEncoder, init_vit_params, card)

    # 7. files end to end, where the host has what the file paths need
    missing = []
    for mod in ("h5py", "pandas", "cv2", "yaml", "matplotlib", "sklearn"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        emit({"phase": "files", "skipped": f"not installed: {', '.join(missing)}"})
    else:
        emit(files_phase(enc, bundle))

    # 8. head training at full width, then its bundle through the serving path
    train_phase(torch, card, user_tf32, cfg.hidden_size)

    route_launches = {
        "attention_fat": flat_launches, "attention_packed": packed_launches,
        "attention_headmajor": vit7b_launches,
    }
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library", "ms_norope", "gflop", "mbytes", "share_of_bound")
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": route_launches[name][name],
        "launches_sm90": route_launches[name]["sm90"],
        "body": main_cases[name][0]["body"], "inputs": main_cases[name][0]["inputs"],
        **{key: main_cases[name][0][key] for key in timing_keys},
        "shape": [main_cases[name][0][x] for x in ("B", "N", "H", "head_dim")],
        "at_640x480": {key: main_cases[name][1][key] for key in timing_keys}
        | {"shape": [main_cases[name][1][x] for x in ("B", "N", "H", "head_dim")]},
    } for name, replaces in KERNELS.items()]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


def vit7b_phase(torch, fa, FrameEncoder, init_vit_params, card):
    """DINOv3 ViT-7B/16's width (hidden 4096, 32 heads of 128, gated MLP
    8192) at depth 4, opened from a checkpoint directory's config.json with
    random weights; returns (launches, the encode line)."""
    with tempfile.TemporaryDirectory() as ckpt:
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump({**VIT7B_CONFIG, "num_hidden_layers": VIT7B_DEPTH}, f)
        t = time.perf_counter()
        enc = FrameEncoder(ckpt, random_init=True, device="cuda")
        init_s = time.perf_counter() - t
        cfg = enc.cfg
        want_shape = tuple(VIT7B_CONFIG[k] for k in (
            "hidden_size", "num_attention_heads", "intermediate_size")) + (VIT7B_DEPTH, True)
        got_shape = (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.num_layers,
                     cfg.use_gated_mlp)
        if got_shape != want_shape:
            raise AssertionError(f"ViT-7B config resolved to {cfg}")
        rng = np.random.default_rng(SEED + 7)
        planes_256 = rng.integers(0, 256, (FRAMES_7B_256, 256, 256), np.uint8)
        planes_480 = rng.integers(0, 256, (BATCH_7B_480, 480, 640), np.uint8)

        torch.cuda.synchronize()
        reset_launches(fa)
        t = time.perf_counter()
        emb_256, fwd_256 = encode_stream(enc, planes_256, BATCH_7B_256)
        emb_480, fwd_480 = encode_stream(enc, planes_480, BATCH_7B_480)
        path_s = time.perf_counter() - t
        launches = read_launches(fa)
        want = check_launches(
            "head-major", launches, "attention_headmajor", cfg.num_layers - 1, fwd_256 + fwd_480,
            sm90=True,
        )
        for name, e, n in (("256x256", emb_256, FRAMES_7B_256), ("640x480", emb_480, BATCH_7B_480)):
            if e.shape != (n, cfg.hidden_size) or e.dtype != np.float16 or not np.isfinite(e).all():
                raise AssertionError(f"ViT-7B {name} embeddings: {e.shape} {e.dtype}")
        line = {
            "phase": "encode_vit7b", "route": "head-major (K3)",
            "model": "DINOv3 ViT-7B/16 width (hidden 4096, 32 heads x 128, gated MLP 8192)",
            "depth": f"{VIT7B_DEPTH} of {VIT7B_PUBLISHED_DEPTH} blocks (cut: a numpy init of "
                     "all 40 is 27 GB of fp32 on the host)",
            "dtype": "bfloat16", "frames_256": FRAMES_7B_256, "batch_256": BATCH_7B_256,
            "frames_480": BATCH_7B_480, "forwards": fwd_256 + fwd_480,
            "launches": launches, "expected_launches": want, "init_s": init_s,
            "main_path_s": path_s,
            "warm_fps_256": warm_fps(torch, enc, planes_256, BATCH_7B_256, 3),
            "warm_fps_480": warm_fps(torch, enc, planes_480, BATCH_7B_480, 3),
            "card": card,
        }
        emit(line)
        del enc
        torch.cuda.empty_cache()

        params = init_vit_params(SEED, cfg)
        cpu = FrameEncoder(ckpt, params=params, compute_dtype=torch.float32, device="cpu")
        gpu32 = FrameEncoder(ckpt, params=params, compute_dtype=torch.float32, device="cuda")
        del params
        accuracy_check(cpu, gpu32, planes_256, emb_256, N_CHECK_7B, "256x256",
                       {"model": "ViT-7B width, depth 4"})
        del cpu, gpu32
        torch.cuda.empty_cache()
    return launches, line


def write_clip(path, n_frames, seed, size=256) -> None:
    """A synthetic 10 fps clip: a moving gradient plus noise."""
    import cv2

    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (size, size))
    yy, xx = np.mgrid[0:size, 0:size]
    for t in range(n_frames):
        frame = (((xx + 2 * t) % 256 + (yy + t) % 128) % 256).astype(np.uint8)
        noise = rng.integers(0, 30, (size, size), np.uint8)
        w.write(cv2.merge([frame, cv2.add(frame, noise), frame]))
    w.release()


def files_phase(enc, bundle, device="cuda") -> dict:
    """A project of two subjects with one synthetic 256x256 clip each:
    encode_file -> infer_h5, checked by row counts, stamp and probability
    sums; then run_training_job on labelled bouts of both clips, and
    infer_h5 with the bundle it wrote."""
    import h5py
    import pandas as pd

    from cbas_tpu_torch.core.config import TrainingConfig
    from cbas_tpu_torch.core.project import Project
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.encode import EncodeConfig, EncodeStats, encode_file
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.engine.orchestrator import run_training_job

    n_frames, behaviors = 200, ["a", "b"]
    with tempfile.TemporaryDirectory() as d:
        project = Project.create_project(d, "smoke")
        h5s, labels = [], {b: [] for b in behaviors}
        for s in range(2):
            video = os.path.join(project.recordings_dir, "day1", f"m{s}", f"m{s}_00001.mp4")
            os.makedirs(os.path.dirname(video))
            write_clip(video, n_frames, SEED + s)
            stats = EncodeStats()
            h5s.append(encode_file(enc, video, config=EncodeConfig(chunk_frames=BATCH_256),
                                   stats=stats))
            rel = os.path.relpath(video, project.path)
            labels["a"].append({"video": rel, "start": 20, "end": 90, "label": "a"})
            labels["b"].append({"video": rel, "start": 110, "end": 180, "label": "b"})
        with h5py.File(h5s[0], "r") as f:
            rows = f["cls"].shape[0]
            stamp = f.attrs.get("encoder_model_identifier")
        probs = pd.read_csv(InferenceSession(bundle, device=device).infer_h5(h5s[0])).to_numpy()
        ok = (
            rows == stats.frames and probs.shape == (rows, len(bundle.behaviors))
            and stamp == enc.identifier and float(np.abs(probs.sum(1) - 1).max()) <= 1e-5
        )
        if not ok:
            raise AssertionError(f"files phase: rows={rows} stamp={stamp} probs={probs.shape}")

        dataset = project.create_dataset("smoke", behaviors, [])
        dataset.labels["labels"] = labels
        dataset.save_labels()
        project.reload()
        task = TrainingConfig(name="smoke", behaviors=behaviors, batch_size=64, epochs=2,
                              learning_rate=1e-3, use_test=False)
        t = time.perf_counter()
        model_dir = run_training_job(project, task, seed=SEED, device=device)
        job_s = time.perf_counter() - t
        if model_dir is None:
            raise AssertionError("files phase: run_training_job wrote no bundle")
        trained = ClassifierBundle.load(model_dir, expected_encoder=project.encoder_model_identifier)
        trained_probs = pd.read_csv(
            InferenceSession(trained, device=device).infer_h5(h5s[1])
        ).to_numpy()
    ok = (
        trained.behaviors == behaviors and trained_probs.shape == (n_frames, len(behaviors))
        and float(np.abs(trained_probs.sum(1) - 1).max()) <= 1e-5
    )
    if not ok:
        raise AssertionError(f"files phase: the trained bundle gave {trained_probs.shape}")
    return {"phase": "files", "frames": rows, "encode_fps": stats.fps,
            "training_job_s": job_s, "trained_bundle": os.path.basename(model_dir),
            "temperature": trained.temperature, "ok": True}


class MemoryCache:
    """Embeddings held in memory, served in the HDF5 handle cache's
    interface (``get(path)["cls"]`` and ``read_window``)."""

    def __init__(self, arrays):
        self.arrays = arrays

    def get(self, path):
        return {"cls": self.arrays[path]}

    def read_window(self, path, start, stop):
        return self.arrays[path][start:stop]


def training_data(dim):
    """The TRAIN_* recordings: ({name: (TRAIN_FRAMES, dim) fp16}, one
    manifest of labelled centres per recording). Whole bouts are labelled,
    in random order, up to TRAIN_LABELLED centres, so windows at a bout's
    edges reach into its neighbours."""
    rng = np.random.default_rng(SEED + 8)
    half = SEQ_LEN // 2
    means = rng.normal(0.0, TRAIN_CLASS_SPREAD, (len(TRAIN_BEHAVIORS), dim)).astype(np.float32)
    arrays, manifests = {}, []
    for r in range(TRAIN_RECORDINGS):
        name = f"rec{r:02d}"
        lengths = rng.integers(*TRAIN_BOUTS, TRAIN_FRAMES // TRAIN_BOUTS[0])
        starts = np.concatenate([[0], np.cumsum(lengths)])
        starts = starts[starts < TRAIN_FRAMES]
        ends = np.append(starts[1:], TRAIN_FRAMES)
        classes = rng.integers(0, len(TRAIN_BEHAVIORS), len(starts))
        x = rng.standard_normal((TRAIN_FRAMES, dim), np.float32)
        x += means[np.repeat(classes, ends - starts)]
        arrays[name] = x.astype(np.float16)
        entries = []
        for b in rng.permutation(len(starts)):
            lo, hi = max(starts[b], half), min(ends[b], TRAIN_FRAMES - half)
            entries += [(name, c, int(classes[b])) for c in range(lo, hi)]
            if len(entries) >= TRAIN_LABELLED:
                break
        manifests.append(entries[:TRAIN_LABELLED])
    return arrays, manifests


@contextlib.contextmanager
def tf32(torch, matmul, cudnn):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def train_step_parity(torch, train_mod, cfg, params, source, device="cuda") -> dict:
    """One train step on the device-gather path, dropout off (no generator),
    class weights, label smoothing and weight decay on, from the same numpy
    params and TRAIN_BATCH windows, on ``device`` and on the CPU."""
    from cbas_tpu_torch.engine.data import BalancedSampler, DeviceWindowStore
    from cbas_tpu_torch.models.convert import deltas_params_from_numpy

    idx = BalancedSampler(source.manifest, cfg.out_features, seed=SEED).epoch_indices()
    weights = np.linspace(0.5, 2.0, cfg.out_features).astype(np.float32)
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        store = DeviceWindowStore(source.manifest, SEQ_LEN, dev, ram=source._ram)
        centers, labels = store.batch_indices(idx[:TRAIN_BATCH], TRAIN_BATCH)
        head = deltas_params_from_numpy(params, cfg, dev)
        head.lstm.flatten_parameters()
        opt = train_mod.make_optimizer(head, TRAIN_LR, STEP_WEIGHT_DECAY, GATE_DECAY)
        step = train_mod.build_train_step(head, opt, weights, 0.1, gather_seq_len=SEQ_LEN)
        t = time.perf_counter()
        loss = float(step(store.features, centers, labels))
        runs[name] = (
            loss, time.perf_counter() - t,
            {n: p.grad.cpu().numpy() for n, p in head.named_parameters()},
            {n: p.detach().cpu().numpy() for n, p in head.named_parameters()},
        )
        del store, head, opt
    (loss_g, s_g, grads_g, new_g), (loss_c, s_c, grads_c, new_c) = runs["card"], runs["cpu"]
    # the share of each bound that the difference uses (<= 1 passes)
    g_max = max(float(np.abs(g).max()) for g in grads_c.values())
    grad_use, weight_use = {}, {}
    for n, g in grads_c.items():
        dg = np.abs(grads_g[n] - g)
        grad_use[n] = float(dg.max() / (STEP_GRAD_RTOL * np.abs(g).max()
                                        + STEP_GRAD_FLOOR * g_max))
        wd = GATE_DECAY if n == "gate" else STEP_WEIGHT_DECAY
        decayed = np.minimum(np.abs(grads_g[n] + wd * params[n]), np.abs(g + wd * params[n]))
        u = np.spacing(np.abs(g) + np.abs(wd * params[n]))
        bound = 1e-6 + TRAIN_LR * (dg + u) / (decayed + 1e-8)
        weight_use[n] = float((np.abs(new_g[n] - new_c[n]) / bound).max())
    grad_err = {n: float(np.abs(grads_g[n] - g).max() / np.abs(g).max())
                for n, g in grads_c.items()}
    line = {
        "phase": "train_step_parity", "path": "device gather, dropout off, TF32 off",
        "batch": TRAIN_BATCH, "loss_cuda": loss_g, "loss_cpu": loss_c,
        "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c), "loss_rtol": STEP_LOSS_RTOL,
        "grad_err_of_max": grad_err, "grad_tol": f"{STEP_GRAD_RTOL} of the tensor's max |g| "
        f"+ {STEP_GRAD_FLOOR} of the head's ({g_max:.3g})",
        "max_grad_bound_use": max(grad_use.values()),
        "worst_grad": max(grad_use, key=grad_use.get),
        "max_weight_err": max(float(np.abs(new_g[n] - new_c[n]).max()) for n in new_c),
        "max_weight_bound_use": max(weight_use.values()),
        "worst_weight": max(weight_use, key=weight_use.get),
        "weight_tol": "1e-6 + lr (|dg| + u) / (min |g + wd p| + 1e-8)",
        "step_s_cuda_cold": s_g, "step_s_cpu": s_c,
    }
    line["ok"] = bool(
        line["loss_rel_err"] <= STEP_LOSS_RTOL and line["max_grad_bound_use"] <= 1.0
        and line["max_weight_bound_use"] <= 1.0 and np.isfinite(loss_g)
    )
    emit(line)
    if not line["ok"]:
        raise AssertionError("a train step on the card disagrees with the CPU's")
    return line


def train_phase(torch, card, user_tf32, dim=768, device="cuda") -> dict:
    """Phase 8: head training at full width on the card, then its bundle
    through the serving path; returns the train line. (``device`` is "cpu"
    only in the CPU test of this function, at a cut size.)"""
    from cbas_tpu_torch.engine import train as train_mod
    from cbas_tpu_torch.engine.calibrate import fit_temperature
    from cbas_tpu_torch.engine.classifier import ClassifierBundle
    from cbas_tpu_torch.engine.data import (
        BalancedSampler, DeviceWindowStore, SequentialSampler, WindowSource,
    )
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.engine.metrics import f1_of
    from cbas_tpu_torch.models.convert import deltas_params_from_numpy
    from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params

    t = time.perf_counter()
    arrays, manifests = training_data(dim)
    n_train = TRAIN_RECORDINGS - TRAIN_VAL_RECORDINGS
    cache = MemoryCache(arrays)
    train_src = WindowSource([e for m in manifests[:n_train] for e in m], SEQ_LEN,
                             cache=cache, preload=True)
    val_src = WindowSource([e for m in manifests[n_train:] for e in m], SEQ_LEN,
                           cache=cache, preload=True)
    data_s = time.perf_counter() - t
    behaviors, half = TRAIN_BEHAVIORS, SEQ_LEN // 2
    cfg = DeltasHeadConfig(in_features=dim, out_features=len(behaviors), seq_len=SEQ_LEN,
                           lstm_hidden_size=HIDDEN)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    train_step_parity(torch, train_mod, cfg, init_deltas_params(SEED, cfg), train_src, device)

    # train_head as a user calls it. It builds its stores through the
    # module's name: a recording subclass shows which data path it took.
    stores, marks = [], []

    class RecordingStore(DeviceWindowStore):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            stores.append(self)

    def progress(message):
        sync()
        marks.append(time.perf_counter())

    train_mod.DeviceWindowStore = RecordingStore
    try:
        with tf32(torch, *user_tf32):
            t = time.perf_counter()
            params, reports, best = train_mod.train_head(
                train_src, val_src, SEQ_LEN, behaviors, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                epochs=TRAIN_EPOCHS, lstm_hidden_size=HIDDEN, seed=SEED,
                progress_callback=progress, device=device,
            )
            train_head_s = time.perf_counter() - t
    finally:
        train_mod.DeviceWindowStore = DeviceWindowStore
    if len(stores) != 2 or any(s.features.device.type != torch.device(device).type for s in stores):
        raise AssertionError(f"train_head did not take the device-resident path ({len(stores)} stores)")
    val_f1 = f1_of(reports[best].val_report, "weighted avg")

    # Epoch seconds from the progress messages (start, then validation F1);
    # the evaluation's share by timing one epoch's evaluation again.
    head = deltas_params_from_numpy(params, cfg, device)
    head.lstm.flatten_parameters()
    logits_prog = train_mod.build_logits_program(head, gather_seq_len=SEQ_LEN)
    with tf32(torch, *user_tf32):
        sync()
        t = time.perf_counter()
        train_mod.predict_store(logits_prog, stores[0],
                                BalancedSampler(train_src.manifest, len(behaviors), seed=SEED),
                                TRAIN_BATCH)
        train_mod.predict_store(logits_prog, stores[1], SequentialSampler(len(val_src)),
                                TRAIN_BATCH)
        eval_s = time.perf_counter() - t

        # Warm steps/s on the device-gather path, dropout on, on a copy of
        # the head (logits_prog keeps the trained one).
        timed = deltas_params_from_numpy(params, cfg, device)
        timed.lstm.flatten_parameters()
        opt = train_mod.make_optimizer(timed, TRAIN_LR, 0.0)
        step = train_mod.build_train_step(timed, opt, None, 0.0, gather_seq_len=SEQ_LEN)
        generator = torch.Generator(device=device).manual_seed(SEED)
        idx = BalancedSampler(train_src.manifest, len(behaviors), seed=SEED).epoch_indices()
        batches = [stores[0].batch_indices(idx[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], TRAIN_BATCH)
                   for i in range(TRAIN_TIMED_STEPS + 5)]
        for centers, labels in batches[:5]:
            step(stores[0].features, centers, labels, generator)
        sync()
        t = time.perf_counter()
        for centers, labels in batches[5:]:
            step(stores[0].features, centers, labels, generator)
        sync()
        steps_per_s = TRAIN_TIMED_STEPS / (time.perf_counter() - t)
    epoch_s = [b - a for a, b in zip(marks[0::2], marks[1::2])]
    line = {
        "phase": "train", "head": "deltas, 3 streams, bottleneck 128, LSTM in 256, "
        f"biLSTM hidden {HIDDEN}, seq_len {SEQ_LEN}", "embed_dim": dim,
        "behaviors": len(behaviors), "recordings": f"{n_train} train + {TRAIN_VAL_RECORDINGS} "
        f"validation, {TRAIN_FRAMES} frames each", "train_centres": len(train_src),
        "val_centres": len(val_src), "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS,
        "lr": TRAIN_LR, "tf32": {"matmul": user_tf32[0], "cudnn": user_tf32[1]},
        "data_s": data_s, "device_path": True,
        "store_bytes_on_device": sum(s.features.numel() * s.features.element_size()
                                     for s in stores),
        "train_head_s": train_head_s, "epoch_s": epoch_s, "eval_s_per_epoch": eval_s,
        "train_s_per_epoch": [s - eval_s for s in epoch_s],
        "warm_steps_per_s": steps_per_s, "steps_per_epoch": -(-len(idx) // TRAIN_BATCH),
        "best_epoch": best, "val_weighted_f1": val_f1,
        "val_f1_by_epoch": [f1_of(r.val_report, "weighted avg") for r in reports],
        "min_val_f1": TRAIN_MIN_F1, "card": card,
    }
    line["ok"] = bool(val_f1 >= TRAIN_MIN_F1 and len(reports) == TRAIN_EPOCHS)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"train_head reached validation F1 {val_f1} < {TRAIN_MIN_F1}")

    # The trained params as a bundle on disk, loaded back and served (TF32 off).
    with tempfile.TemporaryDirectory() as d:
        ClassifierBundle(name="smoke_trained", behaviors=behaviors, seq_len=SEQ_LEN,
                         params=params, lstm_hidden_size=HIDDEN).save(d)
        bundle = ClassifierBundle.load(d)
    recording = arrays[f"rec{n_train:02d}"]  # a validation recording
    probs = InferenceSession(bundle, device=device).predict_frames(recording, half, half)
    feats = torch.from_numpy(recording).to(device)
    windows = feats.unfold(0, SEQ_LEN, 1).transpose(1, 2)  # centres half .. frames-half-1
    bundle_logits = bundle.logits_fn(device)
    centers = np.arange(half, TRAIN_FRAMES - half)
    want, got = [], []
    with torch.inference_mode():
        for i in range(0, len(centers), TRAIN_BATCH):
            want.append(logits_prog(feats, centers[i:i + TRAIN_BATCH]))
            got.append(bundle_logits(windows[i:i + TRAIN_BATCH].float()))
    want, got = torch.cat(want), torch.cat(got)
    logits_err = float((got - want).abs().max())
    probs_err = float(np.abs(
        probs[half:TRAIN_FRAMES - half]
        - torch.softmax(want / bundle.temperature, -1).cpu().numpy()).max())
    row_sum_err = float(np.abs(probs.sum(1) - 1).max())
    t = time.perf_counter()
    temperature = fit_temperature(params, cfg, val_src, batch_size=TRAIN_BATCH, device=device)
    calibrate_s = time.perf_counter() - t
    serve = {
        "phase": "train_serve", "frames": TRAIN_FRAMES, "shape": list(probs.shape),
        "max_row_sum_err": row_sum_err, "max_logits_err_vs_logits_program": logits_err,
        "max_probs_err_vs_logits_program": probs_err, "tol": SERVE_TOL,
        "temperature": temperature, "calibrate_s": calibrate_s,
    }
    serve["ok"] = bool(
        probs.shape == (TRAIN_FRAMES, len(behaviors)) and np.isfinite(probs).all()
        and row_sum_err <= SERVE_TOL and logits_err <= SERVE_TOL and probs_err <= SERVE_TOL
        and 1e-3 < temperature <= 10.0
    )
    emit(serve)
    if not serve["ok"]:
        raise AssertionError("the trained bundle's serving path disagrees with build_logits_program")
    return line


if __name__ == "__main__":
    sys.exit(main())
