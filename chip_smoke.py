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
     (an odd head count), at head dims 96 and 40, and at head dims 192 and
     256, wider than any shipped preset's heads (timed at 16 heads); and on
     head-major views of flat tensors (the head-major route's operands) at
     d 64, 128, 192, 256 and 320, N 261, 329 and 1205 and 272 / 261 and
     329 / 300, each view case also bit for bit against the kernel on
     contiguous copies.
   bf16 at head dims 64 and 128 (and K3's 192 and 256) runs the Hopper body
   (``attention_body``), the rest the common body; each case names the
   registers and spills of the kernel it ran (``-Xptxas -v``). At the main
   shapes (K2: on both inputs) each
   kernel is timed with RoPE and without, beside its plain version, its
   bound (FLOP and bytes over the card's peaks) and
   ``scaled_dot_product_attention`` on the same data (head-major, RoPE
   applied beforehand; the backend it picked is named by its kernels in a
   profiler trace). K1, K2 (views) and K3 (views, d 64 and 128) are also
   timed in fp32 at the main shapes, the common body
   (``runtime.compute_dtype: float32``);
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
   one batch: K3 only, each through the Hopper body, on views of the
   projections: a profiler trace of one forward finds no copy kernel next
   to a K3 launch. Warm frames/s, and accuracy against the CPU fp32 run
   (its launches are the fp32 forward's, as are those of the flat and
   packed routes' fp32 runs, checked a forward);
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
   loaded and run by ``InferenceSession``, and ``fit_temperature``;
9. app: the port's JSON-RPC server over ``Api(device="cuda")`` on a copy of
   ``examples/demo_project``: ``load_project`` over HTTP with the encoder's
   weights on the card, and the app's encoder (K1, each launch through the
   Hopper body) against the CPU fp32 run. Where h5py, pandas and OpenCV are
   installed, also: the encode queue drained and one H5 held against the CPU
   run, one clip re-encoded with ``reuse_threshold`` 6.0 against the same
   gate run on the host, two epochs of training, classification of every
   clip, and (with matplotlib) the ethogram. Each step the host cannot run is
   named in the line with the package it lacks;
10. tools: ``tools/validate_kernels.py`` on the card at its geometries plus
    (2, 32, 261, 128) with RoPE (K1, K2 and K3 in fp32 against an fp64
    oracle, then K3 in bf16 at d = 128 through the Hopper body against
    unfused bf16, and the bf16 LayerNorm), each error beside its tolerance
    and each kernel's launches by body; K3 at head dims it is not built at
    (100, zero-padded to 104; 136, 160, 200 and 248, run at 192 or 256
    with no copy in bf16 and zero-padded in fp32), bf16 and fp32, RoPE on
    and off, against the plain version at d, timed beside the built width
    and SDPA at d, with K3's launches and the CUDA kernels of one call (a
    profiler trace: bf16 at a multiple of 8 runs one kernel, two with
    RoPE); ``models/vit.py::cls_attention_map`` at dinov3-vitb16 (full
    width and depth, q/k weights x4 so the map is far from uniform) on 8
    frames of 256x256 in bf16, 11 K1 launches a call through the Hopper
    body, against the CPU fp32 run; and, where h5py, pandas, OpenCV and
    matplotlib import, ``tools/encode_fleet.py`` with one worker over two
    clips (its H5s against an in-process ``encode_file``) and
    ``tools/soak.py`` with two cameras for half a minute at full size
    (otherwise a ``skipped`` entry names what is missing). Then K3 at the
    head dims it refused on the card before: (8, 261, 16, 320) and (4, 1205,
    8, 384) on the wide body, (8, 261, 16, 65) with RoPE tables, bf16 and
    fp32, each against the plain version and timed beside its bound and SDPA;
    the padded, wide and odd cases name the body they ran and its registers;
11. mesh: the device mesh in one process, one thread a shard, over logical
    shards of cuda:0 (``runtime_mesh()`` is None on one card and is
    printed): dinov3-vitb16 at full width over (data 2, model 2) and (1, 4),
    and (2, 2) again with ``CBAS_ATTN_FAT=0``, each against the one-device
    encoder (bf16 cosine >= 0.999) with its K1, K2 or K3 launches counted
    per shard and each model shard's q-projection rows; the ViT-7B width
    over model 2 (K3 at 16 heads of 128 a shard); one DP train step over
    data 2 against the one-device step; DP inference against one device.
    Sharded and one-device frames/s are printed side by side; on logical
    shards of one card they record that the path runs, not scaling. With
    two cards or more the phase runs again over distinct cards
    (``mesh_multi_gpu``), else that line says it was skipped;
12. wide heads: encoders of 8 heads of 192, 256 and 320 at depth 2 (random
    weights, opened from a checkpoint directory's config.json), 32 frames of
    256x256 in bf16 each: K3 once a forward through the Hopper body at 192
    and 256 and the wide body at 320 (the counts set to 0 before each run
    and read after it), embeddings against the CPU fp32 run; then K3 alone
    at the shape each encode gave it, against its plain version and timed.

The line before the last lists each kernel with its launches on its route,
error, times, bound, registers and the library call's time (K2 and K3 on
views, their routes' inputs, with their times on contiguous tensors beside;
each also in fp32, with its launches of one fp32 forward; K3 also at head
dims 192 and 256, at phase 10's padded, wide and odd widths, with their
launches counted over the encode routes' runs and phase 12's), the launches
of phase 10's runs, and its launches over phase 11's mesh encodes
(``launches_mesh``), then K3's wide body (``attention_wide.cuh``) as an
entry of its own, its launches those of phase 12 and its numbers those of
phase 12's kernel case at d 320; the last line is
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
# K3's head dims above 128, timed at 16 heads (a 3072- and a 4096-wide model);
# no shipped preset has such heads. Their launches on the encode routes are
# counted all the same (``launches_on_main_path``).
WIDE_HEAD_DIMS, WIDE_HEADS = (192, 256), 16
# 12. The same widths and one above 256 through the encoder: checkpoint
# directories whose config.json has 8 heads of 192, 256 and 320 (hidden 1536,
# 2048 and 2560, gated MLP twice the hidden width, the ViT-7B config's other
# fields) at depth 2, random weights from SEED. No public DINO checkpoint has
# such heads: this drives K3's Hopper body at 192 and 256 and its wide body
# through FrameEncoder as a checkpoint of that shape would.
WIDE_ENCODER_HEAD_DIMS, WIDE_ENCODER_HEADS, WIDE_ENCODER_DEPTH = (192, 256, 320), 8, 2
WIDE_ENCODER_FRAMES = 32

# The three kernels (source cbas_tpu_torch/csrc/<name>.cu) and the TPU kernel
# each replaces.
# The card's peaks (NVIDIA's H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its FLOP over the rate of its inputs' type (bf16 on
# the tensor cores, fp32 outside them) and its bytes (each input read once,
# each output written once) over the memory rate.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 989e12, 67e12, 3.35e12
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


# Each kernel library's ``-Xptxas -v`` report, {library: {kernel: "N regs,
# S/L spill"}}, filled once the kernels are built (``kernel_ptxas`` reads it).
PTXAS: dict = {}


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log, as
    "<dtype><head dim>: N regs, S/L spill" strings."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(attention_bf16|attention_f32|attention_sm90)ILi(\d+)E"
                          r"(?:Li(\d+)E)?", m.group(1))
            args = ", ".join(x for x in k.groups()[1:] if x) if k else ""
            name = f"{k.group(1).replace('attention_', '')}<{args}>" if k else m.group(1)
            r = re.search(r"rope_rowsI(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
            if r:  # the RoPE prologue: its dtype and the columns a thread takes
                name = f"rope_rows<{'f32' if r.group(1) == 'f' else 'bf16'}, {r.group(2)}>"
            w = re.search(r"(attention_wide_bf16|attention_wide_f32)"
                          r"(?:I(f|13__nv_bfloat16|Lb[01])E)?", m.group(1))
            if w:  # the wide body and its prologue: d at run time, not a template argument
                name = w.group(1).replace("attention_", "")
                if w.group(2) in ("Lb1", "Lb0"):  # Q resident, or streamed above d = 1024
                    name += "<resident Q>" if w.group(2) == "Lb1" else "<streamed Q>"
                elif w.group(2):
                    name += f"<{'f32' if w.group(2) == 'f' else 'bf16'}>"
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


def kernel_ptxas(fa, kernel, dtype, d) -> str:
    """Registers and spills of the kernel ``kernel`` runs at head dim ``d``
    (K3: the width it pads to) in ``dtype``, from PTXAS."""
    width = fa.padded_head_dim(d) if kernel == "attention_headmajor" else d
    bf16 = str(dtype) == "torch.bfloat16"
    wide_bf16 = f"wide_bf16<{'resident' if d <= 1024 else 'streamed'} Q>"
    prefix = {"sm90": f"sm90<{width}, ", "wide": wide_bf16 if bf16 else "wide_f32",
              "common": f"{'bf16' if bf16 else 'f32'}<{width}>"}[fa.attention_body(kernel, dtype, width)]
    found = [v for k, v in PTXAS.get(kernel, {}).items() if k.startswith(prefix)]
    return found[0] if found else "not in the build log"


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
                time_it=True, view=False, tables=None):
    """One fused-attention case on the card against its plain version, in
    the kernel's own layout; with ``view`` (K2 and K3), on head-pair or
    head-major views of flat (B, N, H*d) tensors, as the packed and
    head-major routes pass them, and then also bit for bit against the
    kernel on contiguous copies of the views. ``tables``, a (cos, sin) pair
    on the card, replaces the model's RoPE tables."""
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
        group = 2 if kernel == "attention_packed" else 1
        q, k, v = (t.view(B, N, H // group, group * d).transpose(1, 2) for t in (q, k, v))
    if n_valid is not None:  # dead rows hold NaN: the masks must keep it out
        dead = (slice(None),) * token_dim + (slice(n_valid, None),)
        k[dead] = float("nan")
        v[dead] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = tables or rope_full(torch, cfg, d, grid, N, "cuda")
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
    if view:  # the views' strides kept, and the same bits as on contiguous copies
        copies = wrapper(*(t.contiguous() for t in (q, k, v)), scale, n_valid, cos, sin)
        ok = ok and got.stride() == q.stride() and bool(torch.equal(got, copies))
    out = {
        "phase": "kernel", "name": kernel, "body": fa.attention_body(kernel, dtype, d),
        "inputs": "views of flat tensors" if view else "contiguous",
        "B": B, "N": N, "H": H, "head_dim": d,
        "dtype": str(dtype).replace("torch.", ""), "rope": rope, "n_valid": n_valid,
        "max_abs_err": float(err.max()), "tol": tol_text, "ok": ok,
        "ptxas": kernel_ptxas(fa, kernel, dtype, d),
    }
    if time_it:
        out["ms"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid, cos, sin))
        out["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, scale, n_valid, cos, sin))
        out["ms_norope"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid))
        out.update(attention_bound(B, N, H, d, n_valid or N, rope, dtype == torch.float32))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        heads = {"attention_fat": lambda t: t.reshape(B, N, H, d).transpose(1, 2),
                 "attention_packed": lambda t: t.reshape(B, H // 2, N, 2, d).transpose(2, 3)
                 .reshape(B, H, N, d),
                 "attention_headmajor": lambda t: t}[kernel]
        out["library_ms"], out["library_kernels"] = library_case(
            torch, fa, heads(q), heads(k), heads(v), scale, cos, sin)
        out["library"] = sdpa_backend(out["library_kernels"])
    return out


def attention_bound(B, N, H, d, n_valid, rope, fp32=False) -> dict:
    """The least time the card could take for one fused attention: q.k^T
    and p.V over the live keys at the peak of the inputs' type (bf16 on the
    tensor cores, fp32 outside them), against q and o (N rows), k and v
    (n_valid rows) and the fp32 RoPE tables moved once."""
    flop = 4 * B * H * N * n_valid * d
    nbytes = (4 if fp32 else 2) * B * H * d * (2 * N + 2 * n_valid) + (2 * N * d * 4 if rope else 0)
    t_ops = flop / (PEAK_F32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
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
    {name: (256x256 case, 640x480 case)} (the ``kernels`` line's numbers;
    under "<name>_contiguous" K2's and K3's on contiguous tensors), the fp32
    cases under "fp32", and under "padded_calls" the kernels one K3 call
    launches at phase 10's padded widths (:func:`padded_calls`)."""
    g256, g288, g480 = (16, 16), (18, 18), (30, 40)  # patch grids of 256x256, 288x288, 640x480
    bf16, f32 = torch.bfloat16, torch.float32
    results, main = [], {}

    def sweep(kernel, H, d, small=((4, 261, g256), (2, 1205, g480)), ropes=(False, True),
              dead=((4, 272, 261, g256), (2, 1216, 1205, g480)), views=(False,), time_it=True):
        for view in views:
            for B, N, grid in small:
                for dtype in (bf16, f32):
                    for rope in ropes:
                        results.append(kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype,
                                                   rope, view=view, time_it=time_it))
            for B, N, n_valid, grid in dead:  # NaN in the dead rows
                for dtype in (bf16, f32):
                    for rope in ropes:
                        results.append(kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype,
                                                   rope, n_valid=n_valid, view=view,
                                                   time_it=time_it))

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
    for d in (192, 256):  # wider than 128: the Hopper body in bf16
        sweep("attention_headmajor", 4, d, small=((2, 261, g256),),
              dead=((2, 272, 261, g256),))
    # K3 on head-major views of flat tensors (the head-major route's
    # operands) on each body: N 261, 329 and 1205, and 272 / 261 and
    # 329 / 300 with NaN in the dead rows; each also against the kernel on
    # contiguous copies, bit for bit. Untimed: the main shapes are timed below.
    for d in (64, 128, 192, 256, 320):
        sweep("attention_headmajor", 4, d, views=(True,),
              small=((2, 261, g256), (2, 329, g288), (1, 1205, g480)),
              dead=((2, 272, 261, g256), (2, 329, 300, g288)), time_it=False)
    # The main paths' shapes: ViT-B at batch 128 / 32, ViT-7B width at 32 / 8.
    # K2 and K3 on contiguous tensors here; on views (their routes' inputs)
    # below.
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
    # K3 at the wide heads, at ViT-7B's batch and a width near its 4096.
    for d in WIDE_HEAD_DIMS:
        main[f"headmajor_d{d}"] = kernel_case(torch, fa, cfg, "attention_headmajor", BATCH_7B_256,
                                              WIDE_HEADS, 261, d, g256, bf16, True)
        results.append(main[f"headmajor_d{d}"])
    # K2 and K3 on views of flat tensors, their routes' inputs: the kernels
    # line's numbers.
    for kernel, H, d, b256, b480 in (
        ("attention_packed", cfg.num_heads, 64, BATCH_256, BATCH_480),
        ("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128, BATCH_7B_256,
         BATCH_7B_480),
    ):
        main[f"{kernel}_contiguous"] = main[kernel]
        main[kernel] = tuple(
            kernel_case(torch, fa, cfg, kernel, b, H, n, d, g, bf16, True, view=True)
            for b, n, g in ((b256, 261, g256), (b480, 1205, g480)))
        results += main[kernel]
    # fp32 (runtime.compute_dtype: float32) on the main paths' shapes, the
    # common body: K1, K2 (views) and K3 (views) at d 64, and K3 (views) at
    # the ViT-7B width.
    main["fp32"] = [
        kernel_case(torch, fa, cfg, kernel, b, H, n, d, g, f32, True,
                    view=kernel != "attention_fat")
        for kernel, H, d, b256, b480 in (
            ("attention_fat", cfg.num_heads, 64, BATCH_256, BATCH_480),
            ("attention_packed", cfg.num_heads, 64, BATCH_256, BATCH_480),
            ("attention_headmajor", cfg.num_heads, 64, BATCH_256, BATCH_480),
            ("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128, BATCH_7B_256,
             BATCH_7B_480))
        for b, n, g in ((b256, 261, g256), (b480, 1205, g480))]
    results += main["fp32"]
    main["padded_calls"] = padded_calls(torch, fa, cfg)
    for r in results:
        emit(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused attention disagrees with its plain version: {bad}")
    return main


def reset_launches(fa) -> None:
    fa.launches = fa.launches_packed = fa.launches_headmajor = fa.launches_sm90 = 0
    fa.launches_wide = 0
    fa.launches_headmajor_by_dim.clear()
    fa.launches_sm90_by_kernel.clear()


def read_launches(fa) -> dict:
    """Launches of each entry, under "sm90" those that ran the Hopper body
    (by entry under "sm90_by_kernel"), under "wide" K3's that ran the wide
    body, and under "headmajor_by_dim" K3's split by the head dim it ran at."""
    return {"attention_fat": fa.launches, "attention_packed": fa.launches_packed,
            "attention_headmajor": fa.launches_headmajor, "sm90": fa.launches_sm90,
            "wide": fa.launches_wide,
            "sm90_by_kernel": dict(fa.launches_sm90_by_kernel),
            "headmajor_by_dim": dict(fa.launches_headmajor_by_dim)}


def check_launches(route, got, kernel, per_forward, forwards, sm90) -> dict:
    """The route launched ``kernel`` ``per_forward`` times a forward, and no
    other kernel; each launch through the Hopper body if ``sm90``, else none."""
    want = {name: 0 for name in KERNELS}
    want[kernel] = per_forward * forwards
    want["sm90"] = want[kernel] if sm90 else 0
    if {name: got[name] for name in want} != want:
        raise AssertionError(f"{route} route launched {got}, expected {want}")
    if sum(got["headmajor_by_dim"].values()) != got["attention_headmajor"]:
        raise AssertionError(f"{route} route: K3's launches by head dim do not add up: {got}")
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


def accuracy_check(cpu, gpu32, planes, e_bf16, n, name, extra=None, fa=None) -> dict:
    """The GPU fp32 run within 1 fp16 ulp + floor of the CPU fp32 run, and
    the bf16 embeddings within the cosine bound of it. With ``fa``, the
    kernel launches of the GPU fp32 run (one forward) under
    "fp32_launches"."""
    ref = cpu.encode_planes(planes[:n]).astype(np.float32)
    if fa is not None:
        reset_launches(fa)
    g32 = gpu32.encode_planes(planes[:n]).astype(np.float32)
    launches = read_launches(fa) if fa is not None else None
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
        **({"fp32_launches": launches} if launches is not None else {}),
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
    reports = {name: ptxas_report(lib.with_suffix(".log").read_text())
               for name, (lib, _) in libs.items()}
    PTXAS.update({name: dict(line.split(": ", 1) for line in report)
                  for name, report in reports.items()})
    emit({
        "phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "card": card,
        "device": torch.cuda.get_device_name(0), "build_s": time.perf_counter() - t,
        "build_s_each": {name: s for name, (_, s) in libs.items()},
        "ptxas": reports,
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
    fp32_flat = accuracy_check(cpu, gpu32, planes_256, emb_256, N_CHECK_256, "256x256",
                               fa=fa)["fp32_launches"]
    accuracy_check(cpu, gpu32, planes_480, emb_480, N_CHECK_480, "640x480")
    with env_var("CBAS_ATTN_FAT", "0"):  # the packed route in fp32, one forward
        reset_launches(fa)
        gpu32.encode_planes(planes_256[:N_CHECK_256])
        fp32_packed = read_launches(fa)
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
    vit7b_launches, vit7b_line, fp32_headmajor = vit7b_phase(torch, fa, FrameEncoder,
                                                             init_vit_params, card)
    # Launches of one fp32 forward (runtime.compute_dtype: float32) on each
    # route: the same kernel counts as bf16, none through the Hopper body.
    fp32_runs = {"attention_fat": fp32_flat, "attention_packed": fp32_packed,
                 "attention_headmajor": fp32_headmajor}
    for name, run in fp32_runs.items():
        layers = (VIT7B_DEPTH if name == "attention_headmajor" else cfg.num_layers) - 1
        check_launches(f"{name} fp32", run, name, layers, 1, sm90=False)
    fp32_launches = {name: run[name] for name, run in fp32_runs.items()}

    # 7. files end to end, where the host has what the file paths need
    missing = host_missing(("h5py", "pandas", "cv2", "yaml", "matplotlib", "sklearn"))
    if missing:
        emit({"phase": "files", "skipped": f"not installed: {', '.join(missing)}"})
    else:
        emit(files_phase(enc, bundle))

    # 8. head training at full width, then its bundle through the serving path
    train_phase(torch, card, user_tf32, cfg.hidden_size)

    # 9. the app over HTTP on the card
    app_phase(torch, fa, card)

    # 10. the tools, K3 at padded, wide and odd widths and the CLS attention map
    tools_line = tools_phase(torch, fa, cfg, params, card, main_cases["padded_calls"])

    # 11. the device mesh over logical shards of cuda:0, then over the cards
    mesh_launches, _ = mesh_phase(torch, fa, cfg, enc, planes_256[:BATCH_256],
                                  emb_256[:BATCH_256], bundle, probs, emb_256, card)
    if torch.cuda.device_count() >= 2:
        mesh_phase(torch, fa, cfg, enc, planes_256[:BATCH_256], emb_256[:BATCH_256], bundle,
                   probs, emb_256, card, real=True)
    else:
        emit({"phase": "mesh_multi_gpu", "skipped": "one CUDA device visible"})

    # 12. K3's Hopper body at 192 and 256 and its wide body through the encoder
    wide_runs, wide_cases = wide_heads_phase(torch, fa, FrameEncoder, init_vit_params, card)

    route_launches = {
        "attention_fat": flat_launches, "attention_packed": packed_launches,
        "attention_headmajor": vit7b_launches,
    }
    # K3's launches at each head dim above 128 over the encode runs, phase 12's included
    runs = [*route_launches.values(), *wide_runs.values()]
    wide_launches = {d: sum(run["headmajor_by_dim"].get(d, 0) for run in runs)
                     for d in WIDE_HEAD_DIMS}
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library", "ms_norope", "gflop", "mbytes", "share_of_bound", "ptxas")
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": route_launches[name][name],
        "launches_sm90": route_launches[name]["sm90"],
        "body": main_cases[name][0]["body"], "inputs": main_cases[name][0]["inputs"],
        **{key: main_cases[name][0][key] for key in timing_keys},
        "shape": [main_cases[name][0][x] for x in ("B", "N", "H", "head_dim")],
        "at_640x480": {key: main_cases[name][1][key] for key in timing_keys}
        | {"shape": [main_cases[name][1][x] for x in ("B", "N", "H", "head_dim")]},
        **({f"at_head_dim_{d}": {key: main_cases[f"headmajor_d{d}"][key] for key in timing_keys}
            | {"shape": [main_cases[f"headmajor_d{d}"][x] for x in ("B", "N", "H", "head_dim")],
               "body": main_cases[f"headmajor_d{d}"]["body"],
               "launches_on_main_path": wide_launches[d]}
            for d in WIDE_HEAD_DIMS} if name == "attention_headmajor" else {}),
        **({"at_padded_widths": [
            c | {"launches_on_main_path": sum(run["headmajor_by_dim"].get(c["padded_to"], 0)
                                              for run in runs)}
            for c in tools_line["padded_timings"]],
            "at_wide_and_odd_head_dims": [
            c | {"launches_on_main_path": sum(run["headmajor_by_dim"].get(c["padded_to"], 0)
                                              for run in runs)}
            for c in tools_line["wide_odd_timings"]]} if name == "attention_headmajor" else {}),
        **({"contiguous": [{key: c[key] for key in ("ms", "ms_norope", "max_abs_err")}
                           | {"shape": [c[x] for x in ("B", "N", "H", "head_dim")]}
                           for c in main_cases[f"{name}_contiguous"]]}
           if f"{name}_contiguous" in main_cases else {}),
        "fp32": [{key: c[key] for key in timing_keys}
                 | {"shape": [c[x] for x in ("B", "N", "H", "head_dim")], "body": c["body"],
                    "inputs": c["inputs"]}
                 for c in main_cases["fp32"] if c["name"] == name],
        "launches_fp32": fp32_launches[name],
        "launches_mesh": mesh_launches[name],
        "launches_tools": {run: launches[name] for run, launches in tools_line["launches"].items()},
    } for name, replaces in KERNELS.items()]
        + [wide_kernel_entry(tools_line, wide_runs, wide_cases)]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


COPY_KERNEL = re.compile(r"copy|memcpy", re.IGNORECASE)


def trace_kernels(torch, fn) -> list:
    """The names of the CUDA kernels (and copies) one call of ``fn`` ran, in
    the order they started, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def copies_around(kernels, marker, prologue="rope_rows") -> dict:
    """Of a kernel trace: the copy kernels in all, the launches of kernels
    whose name holds ``marker``, and the copy kernels that run next to one
    of them (right before it, past its ``prologue``, or right after it),
    with the names of those neighbours."""
    hits, around, neighbours = 0, 0, set()
    for i, name in enumerate(kernels):
        if marker not in name:
            continue
        hits += 1
        j = i - 1
        while j >= 0 and prologue in kernels[j]:
            j -= 1
        for k in (j, i + 1):
            while 0 <= k < len(kernels) and COPY_KERNEL.search(kernels[k]):
                around += 1
                neighbours.add(kernels[k][:120])
                k += 1 if k > i else -1
            if 0 <= k < len(kernels):
                neighbours.add(kernels[k][:120])
    return {"kernels": len(kernels), "copy_kernels": sum(bool(COPY_KERNEL.search(n)) for n in kernels),
            "launches": hits, "copies_around": around, "neighbours": sorted(neighbours)}


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
        # One forward traced: the route hands K3 views of the projections and
        # reads its output back as a view, so no copy kernel runs next to a
        # K3 launch.
        copies = copies_around(trace_kernels(torch, lambda: enc.encode_planes(
            planes_256[:BATCH_7B_256], batch=BATCH_7B_256)), "attention_sm90")
        if copies["launches"] != cfg.num_layers - 1 or copies["copies_around"]:
            raise AssertionError(f"ViT-7B forward: copies next to K3: {copies}")
        line = {
            "phase": "encode_vit7b", "route": "head-major (K3)",
            "one_forward_trace": copies,
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
        fp32_launches = accuracy_check(cpu, gpu32, planes_256, emb_256, N_CHECK_7B, "256x256",
                                       {"model": "ViT-7B width, depth 4"},
                                       fa=fa)["fp32_launches"]
        del cpu, gpu32
        torch.cuda.empty_cache()
    return launches, line, fp32_launches


def wide_heads_phase(torch, fa, FrameEncoder, init_vit_params, card) -> tuple:
    """Phase 12: an encoder at each of WIDE_ENCODER_HEAD_DIMS (8 heads, depth
    2, opened from a checkpoint directory's config.json with random weights)
    on WIDE_ENCODER_FRAMES frames of 256x256 in bf16: K3 once a forward, at
    the head dim itself, through the Hopper body at 192 and 256 and the wide
    body at 320; the embeddings against the CPU fp32 run. Then K3 alone at
    the shape that path gives it (the frames as the batch, the encoder's
    heads, tokens and RoPE tables) against its plain version, timed, after
    the launches are read. Returns ({head dim: launches}, {head dim: that
    kernel case})."""
    planes = np.random.default_rng(SEED + 12).integers(0, 256, (WIDE_ENCODER_FRAMES, 256, 256),
                                                       np.uint8)
    runs, cases = {}, {}
    for d in WIDE_ENCODER_HEAD_DIMS:
        hidden = WIDE_ENCODER_HEADS * d
        with tempfile.TemporaryDirectory() as ckpt:
            with open(os.path.join(ckpt, "config.json"), "w") as f:
                json.dump({**VIT7B_CONFIG, "hidden_size": hidden,
                           "num_attention_heads": WIDE_ENCODER_HEADS,
                           "intermediate_size": 2 * hidden,
                           "num_hidden_layers": WIDE_ENCODER_DEPTH}, f)
            enc = FrameEncoder(ckpt, random_init=True, device="cuda")
            if enc.cfg.head_dim != d:
                raise AssertionError(f"config with {d}-wide heads resolved to {enc.cfg}")
            torch.cuda.synchronize()
            reset_launches(fa)
            t = time.perf_counter()
            emb, forwards = encode_stream(enc, planes, WIDE_ENCODER_FRAMES)
            path_s = time.perf_counter() - t
            got = read_launches(fa)
            body = fa.attention_body("attention_headmajor", torch.bfloat16, d)
            per = (WIDE_ENCODER_DEPTH - 1) * forwards  # the CLS-only last block is plain
            want = {"attention_fat": 0, "attention_packed": 0, "attention_headmajor": per,
                    "sm90": per * (body == "sm90"), "wide": per * (body == "wide"),
                    "headmajor_by_dim": {d: per}}
            if {key: got[key] for key in want} != want:
                raise AssertionError(f"{d}-wide heads launched {got}, expected {want}")
            if emb.shape != (WIDE_ENCODER_FRAMES, hidden) or not np.isfinite(emb).all():
                raise AssertionError(f"{d}-wide heads: embeddings {emb.shape}, "
                                     f"finite={np.isfinite(emb).all()}")
            fps = warm_fps(torch, enc, planes, WIDE_ENCODER_FRAMES, 3)
            grid = (256 // enc.cfg.patch_size,) * 2
            case = kernel_case(torch, fa, enc.cfg, "attention_headmajor", WIDE_ENCODER_FRAMES,
                               WIDE_ENCODER_HEADS, enc.cfg.num_prefix_tokens + grid[0] * grid[1],
                               d, grid, torch.bfloat16, True)
            case["phase"] = "kernel_wide_heads"
            emit(case)
            if not case["ok"] or case["body"] != body:
                raise AssertionError(f"K3 at phase 12's shape, d {d}: {case}")
            params = init_vit_params(SEED, enc.cfg)
            del enc
            cpu = FrameEncoder(ckpt, params=params, compute_dtype=torch.float32, device="cpu")
            cos = row_cosine(emb[:N_CHECK_7B], cpu.encode_planes(planes[:N_CHECK_7B]))
            del cpu
        line = {"phase": "encode_wide_heads", "route": "head-major (K3)", "body": body,
                "model": f"{WIDE_ENCODER_HEADS} heads x {d} (hidden {hidden}, gated MLP "
                         f"{2 * hidden}), depth {WIDE_ENCODER_DEPTH}, random weights",
                "dtype": "bfloat16", "frames": WIDE_ENCODER_FRAMES, "forwards": forwards,
                "launches": got, "expected_launches": want, "main_path_s": path_s,
                "warm_fps_256": fps, "bf16_min_cos_vs_cpu_fp32": float(cos.min()),
                "tol_min_cos": ENCODE_BF16_MIN_COS, "card": card,
                "ok": bool(cos.min() >= ENCODE_BF16_MIN_COS)}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"{d}-wide heads: embeddings disagree with the CPU fp32 run")
        runs[d], cases[d] = got, case
        torch.cuda.empty_cache()
    return runs, cases


def wide_kernel_entry(tools_line, wide_runs, wide_cases) -> dict:
    """The ``kernels`` line's entry for K3's wide body (``attention_wide.cuh``):
    its launches over phase 12's encode at 320-wide heads, its numbers from
    phase 12's kernel case at the shape that encode gives it, and phase 10's
    wide cases beside them."""
    main = wide_cases[max(wide_cases)]
    if main["body"] != "wide":
        raise AssertionError(f"phase 12's widest heads ran the {main['body']} body")
    cases = [c for c in tools_line["wide_odd_timings"] if c["body"] == "wide"]
    return {
        "name": "attention_headmajor_wide", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_wide.cuh",
        "replaces": KERNELS["attention_headmajor"],
        "launches": sum(run["wide"] for run in wide_runs.values()),
        "body": "wide", **{key: main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "gflop", "mbytes", "ptxas")},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "share_of_bound": main["bound_ms"] / main["ms"],
        "other_cases": cases,
    }


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


# 9. The app on the demo project (examples/demo_project: an encoder of 2 heads
# of 64 at depth 2, so K1 once a forward; 8 clips of 300 frames at 64x64).
DEMO_PROJECT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                            "demo_project")
DEMO_CLIPS, DEMO_FRAMES = 8, 300
APP_REUSE_THRESHOLD = 6.0
APP_WAIT_S = 300  # every wait on the app's workers has this deadline


def host_missing(modules) -> list:
    """The modules of ``modules`` this host cannot import."""
    missing = []
    for mod in modules:
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    return missing


def write_spans_clip(path, n_frames, width=64, height=64) -> None:
    """Spans of 10 frames over a static textured background: a still square
    in even spans, a moving one in odd spans, so a reuse gate both reuses
    frames and promotes keys."""
    import cv2

    rng = np.random.default_rng(5)
    background = rng.integers(0, 256, (height, width, 3), np.uint8)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (width, height))
    for i in range(n_frames):
        frame = background.copy()
        span = i // 10
        x = (4 * i if span % 2 else 4 * 10 * span) % (width - 12)
        frame[8:20, x:x + 12] = 255
        w.write(frame)
    w.release()


def rpc(port, method, *args, **kwargs):
    """One JSON-RPC call to the app's server, as the frontend makes it."""
    import urllib.request

    payload = {"args": list(args), **({"kwargs": kwargs} if kwargs else {})}
    req = urllib.request.Request(f"http://localhost:{port}/api/{method}",
                                 data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        doc = json.loads(resp.read())
    if "error" in doc:
        raise AssertionError(f"app: {method} failed: {doc['error']}")
    return doc.get("result")


def wait_for(what, check, seconds=APP_WAIT_S):
    deadline = time.time() + seconds
    while time.time() < deadline:
        got = check()
        if got:
            return got
        time.sleep(0.25)
    raise AssertionError(f"app: {what} not done after {seconds} s")


def app_phase(torch, fa, card, device="cuda") -> dict:
    """Phase 9: the port's app over HTTP on a copy of the demo project;
    returns the phase line. (``device`` is "cpu" only in the CPU test of
    this function.)"""
    import shutil

    from cbas_tpu_torch.app.api import Api
    from cbas_tpu_torch.app.server import RpcServer
    from cbas_tpu_torch.ingest.decode import open_video
    from cbas_tpu_torch.models.encoder import FrameEncoder

    files_missing = host_missing(("h5py", "pandas", "cv2"))
    plots_missing = host_missing(("matplotlib",))
    on_card = device == "cuda"
    line = {"phase": "app", "device": device, "demo": f"{DEMO_CLIPS} clips of {DEMO_FRAMES} "
            "frames at 64x64, encoder 2 heads x 64, depth 2", "ran": [], "skipped": {}}
    clip_rel = os.path.join("recordings", "sess1", "mouse0", "mouse0_00001.mp4")
    with tempfile.TemporaryDirectory() as d:
        proj = os.path.join(d, "demo")
        shutil.copytree(DEMO_PROJECT, proj)
        with open_video(os.path.join(DEMO_PROJECT, clip_rel)) as reader:
            planes = reader.read_green_batch(0, DEMO_FRAMES)
        if files_missing:
            # Without h5py the worker could only fail each clip: queue none.
            shutil.rmtree(os.path.join(proj, "recordings"))
            os.makedirs(os.path.join(proj, "recordings"))
        api = Api(device=device)
        srv = RpcServer(api)
        port = srv.start()
        try:
            # load over HTTP: the encoder's weights on the card
            if on_card:
                torch.cuda.synchronize()
            reset_launches(fa)
            t0 = time.perf_counter()
            if not rpc(port, "load_project", proj)["success"]:
                raise AssertionError("app: load_project failed")
            line["load_s"] = time.perf_counter() - t0
            status = rpc(port, "get_cbas_status")
            line["encoder_device"] = status["encoder_device"]
            if not status["encoder_ready"] or not str(status["encoder_device"]).startswith(device):
                raise AssertionError(f"app: the encoder is not ready on {device}: {status}")
            line["ran"].append("load_project")

            if files_missing:
                for step in ("encode queue", "H5 against the CPU run", "reuse-gated re-encode",
                             "train", "classify", "ethogram"):
                    line["skipped"][step] = f"not installed: {', '.join(files_missing)}"
                # The app's encoder on one clip, straight: the device path runs all the same.
                got = api.state.encoder.encode_planes(planes[:64], batch=64)
                line["launches"] = app_launches(fa, on_card, forwards=1)
                line["ran"].append("the app's encoder on one clip")
            else:
                n_all = DEMO_CLIPS * DEMO_FRAMES
                wait_for("encode queue", lambda: app_drained(port, DEMO_CLIPS))
                line["encode_frames_per_s"] = n_all / (time.perf_counter() - t0 - line["load_s"])
                chunk = api.state.project.settings.encode.chunk_frames
                # a clip shorter than a device batch is one snapped batch
                per_clip = 1 if DEMO_FRAMES < chunk else -(-DEMO_FRAMES // chunk)
                line["launches"] = app_launches(fa, on_card, DEMO_CLIPS * per_clip)
                import h5py

                h5 = os.path.join(proj, clip_rel.replace(".mp4", "_cls.h5"))
                with h5py.File(h5, "r") as f:
                    got = f["cls"][:]
                line["ran"].append("encode queue")
            ref = FrameEncoder(os.path.join(proj, "demo_encoder"), compute_dtype=torch.float32,
                               device="cpu").encode_planes(planes[:len(got)])
            cos = row_cosine(got, ref)
            line["min_cos_vs_cpu_fp32"] = float(cos.min())
            line["tol_min_cos"] = ENCODE_BF16_MIN_COS
            if got.shape != ref.shape or not np.isfinite(got).all() \
                    or cos.min() < ENCODE_BF16_MIN_COS:
                raise AssertionError(f"app: embeddings disagree with the CPU fp32 run ({cos.min()})")
            line["ran"].append("embeddings against the CPU fp32 run")

            if not files_missing:
                line.update(app_file_steps(port, api, proj, clip_rel, plots_missing))
                line["ran"] += ["reuse-gated re-encode", "train", "classify"]
                if plots_missing:
                    line["skipped"]["ethogram"] = f"not installed: {', '.join(plots_missing)}"
                else:
                    line["ran"].append("ethogram")
        finally:
            api.kill_all_processes()
            srv.stop()
    line["card"] = card
    line["ok"] = True
    emit(line)
    return line


def app_drained(port, n) -> bool:
    q = rpc(port, "get_encoding_queue_status")
    return q["total"] >= n and q["done"] == q["total"] and q["queued"] == 0


def app_launches(fa, on_card, forwards) -> dict:
    """The app's encoder went through K1 only, once a forward, each launch
    through the Hopper body (on the card; the CPU runs the plain version)."""
    got = read_launches(fa)
    if on_card:
        return check_launches("app", got, "attention_fat", 1, forwards, sm90=True)
    if any(got.values()):
        raise AssertionError(f"app: kernel launches counted on the CPU: {got}")
    return got


def app_file_steps(port, api, proj, clip_rel, plots_missing) -> dict:
    """The reuse-gated re-encode against the gate run on the host, two
    epochs of training, classification and the ethogram; returns numbers for
    the phase line."""
    import h5py
    import pandas as pd

    from cbas_tpu_torch.core.config import dump_yaml, load_yaml
    from cbas_tpu_torch.engine.encode import _ReuseGate
    from cbas_tpu_torch.ingest.decode import open_video

    out = {}
    # 1. re-encode one clip (static spans) with the reuse gate on
    config = os.path.join(proj, "cbas_config.yaml")
    dump_yaml({**load_yaml(config), "encode": {"reuse_threshold": APP_REUSE_THRESHOLD}}, config)
    video = os.path.join(proj, clip_rel)
    h5 = video.replace(".mp4", "_cls.h5")
    os.remove(h5)
    write_spans_clip(video, DEMO_FRAMES)
    if not rpc(port, "load_project", proj)["success"]:
        raise AssertionError("app: reloading the project failed")
    wait_for("reuse re-encode", lambda: os.path.exists(h5) and app_drained(port, 1))
    with h5py.File(h5, "r") as f:
        rows = f["cls"][:]
    with open_video(video) as reader:
        planes = reader.read_green_batch(0, DEMO_FRAMES)
    settings = api.state.project.settings.encode
    gate, last, key_of = _ReuseGate(settings.reuse_tile, settings.reuse_threshold), None, []
    for i, plane in enumerate(planes):
        if last is None or gate.stat(plane, last) >= settings.reuse_threshold:
            last, key = plane.copy(), i
        key_of.append(key)
    keys = sorted(set(key_of))
    same_as_key = all(np.array_equal(rows[i], rows[k]) for i, k in enumerate(key_of))
    distinct = all(not np.array_equal(rows[a], rows[b]) for a, b in zip(keys, keys[1:]))
    out["reuse"] = {"threshold": APP_REUSE_THRESHOLD, "tile": settings.reuse_tile,
                    "keys": len(keys), "reused": DEMO_FRAMES - len(keys)}
    if rows.shape[0] != DEMO_FRAMES or not same_as_key or not distinct or len(keys) in (1, DEMO_FRAMES):
        raise AssertionError(f"app: the reuse-gated H5 disagrees with the host gate: {out['reuse']}")

    # 2. train two epochs on the committed labels
    marker = os.path.join(proj, "models", "demo_behaviors_model", "model.npz")
    t0 = os.path.getmtime(marker)
    t = time.perf_counter()
    rpc(port, "train_model", "demo_behaviors", epochs=2, sequence_length=15, lstm_hidden_size=16,
        batch_size=64, learning_rate=0.003, num_runs=1, num_trials=1, use_test=False, patience=3)
    wait_for("training", lambda: os.path.getmtime(marker) > t0)
    out["train_s"] = time.perf_counter() - t

    # 3. classify every clip
    if rpc(port, "start_classification", "demo_behaviors_model",
           [os.path.join(proj, "recordings")]) != DEMO_CLIPS:
        raise AssertionError("app: start_classification did not queue every clip")

    def csvs():
        found = sorted(os.path.join(r, f) for r, _, fs in os.walk(proj) for f in fs
                       if f.endswith("_demo_behaviors_model_outputs.csv"))
        return found if len(found) == DEMO_CLIPS else None

    written = wait_for("classification", csvs)
    for csv in written:
        probs = pd.read_csv(csv).to_numpy()
        if probs.shape != (DEMO_FRAMES, 2) or float(np.abs(probs.sum(1) - 1).max()) > 1e-5:
            raise AssertionError(f"app: {csv} holds {probs.shape}")
    out["csvs"] = len(written)

    # 4. the ethogram from one CSV
    if not plots_missing and len(rpc(port, "generate_ethogram", written[0], 10) or "") < 1000:
        raise AssertionError("app: generate_ethogram drew no PNG")
    return out


# 10. The tools. validate_kernels runs its bf16 check at the last geometry it
# is given, so this one, DINOv3 ViT-7B's heads, sends K3 in bf16 through the
# Hopper body.
TOOLS_EXTRA_GEOMETRY = (2, 32, 261, 128, True)
# K3 at head dims it is not built at, (B, N, H, d): the card pads 100 to 104
# (one copy a tensor), and in bf16 runs 136 and 160 at 192 and 200 and 248
# at 256 with no copy (the tensor maps at d; fp32 still pads them).
PADDED_CASES = ((8, 261, 16, 100), (8, 261, 16, 136), (8, 261, 16, 160), (8, 261, 16, 200),
                (8, 261, 16, 248), (4, 1205, 16, 100))
# K3 at the head dims it refused on the card before, (B, N, H, d), with RoPE:
# wider than 256 (the wide body, d at run time) and odd (q and k roped before
# the launch, then zero-padded). d 320 and 384 take the model's tables at
# that width; d 65 random angles (the model's tables need a multiple of 4).
WIDE_ODD_CASES = ((8, 261, 16, 320), (4, 1205, 8, 384), (8, 261, 16, 65))
# The CLS attention map at dinov3-vitb16 on 8 frames of 256x256. Every q and
# k projection weight is scaled by 4, so the random-weight map is far from
# uniform (the line reports its cosine to the uniform map); unscaled, each
# map is nearly uniform and no error would show.
MAP_FRAMES, MAP_QK_GAIN = 8, 4.0
# - map, bf16 on the card vs fp32 on the CPU: the last block's scores are
#   bf16 (2^-9 of logits of order 10, so a few percent of each weight)
#   before the fp32 exponential, after 11 bf16 blocks. Bound: 10% of the
#   largest map value, and a map-wise cosine of 0.99 (the encode's bf16
#   bound).
MAP_ATOL_OF_MAX, MAP_MIN_COS = 0.1, 0.99
# encode_fleet over two clips, and soak at full size, where the host has
# h5py, pandas, OpenCV and matplotlib.
FLEET_CLIPS, FLEET_FRAMES = 2, 100
SOAK_CAMERAS, SOAK_MINUTES = 2, 0.5


def tools_phase(torch, fa, cfg, params, card, calls) -> dict:
    """Phase 10: validate_kernels on the card, K3 at padded widths (``calls``:
    the kernels one call launches there, from phase 2), the CLS attention
    map, and (where the host can) encode_fleet and soak. Returns
    the phase line, with the padded cases' timings and the launches of each
    run for the kernels line."""
    line = {"phase": "tools", "card": card, "launches": {}}
    line["validate_kernels"] = validate_kernels_step(torch, fa, line["launches"])
    cases = padded_cases(torch, fa, cfg, calls)
    line["padded_timings"] = [{key: c[key] for key in (
        "B", "N", "H", "head_dim", "padded_to", "dtype", "rope", "body", "max_abs_err", "tol",
        "ms", "built_width_ms", "ms_norope", "plain_ms", "bound_ms", "bound_by", "gflop",
        "mbytes", "library_ms", "library", "ptxas", "k3_launches_per_call",
        "kernels_per_call")} for c in cases]
    wide = wide_odd_cases(torch, fa, cfg)
    line["wide_odd_timings"] = [{key: c[key] for key in (
        "B", "N", "H", "head_dim", "padded_to", "dtype", "rope", "body", "max_abs_err", "tol",
        "ms", "ms_norope", "plain_ms", "bound_ms", "bound_by", "gflop", "mbytes", "library_ms",
        "library", "ptxas")} for c in wide]
    line["cls_attention_map"] = attention_map_step(torch, fa, cfg, params, line["launches"])
    missing = host_missing(("h5py", "pandas", "cv2", "matplotlib"))
    if missing:
        line["skipped"] = {step: f"not installed: {', '.join(missing)}"
                           for step in ("encode_fleet", "soak")}
    else:
        line["encode_fleet"] = fleet_step()
        line["soak"] = soak_step()
    line["ok"] = True
    emit(line)
    return line


def validate_kernels_step(torch, fa, launches) -> dict:
    """``validate_kernels.main`` on the card at its geometries plus
    TOOLS_EXTRA_GEOMETRY: every check under its tolerance, K1, K2 and K3
    launched as the geometries say, K3's bf16 check through the Hopper body."""
    import io

    from cbas_tpu_torch.tools import validate_kernels

    geometries = list(validate_kernels.GEOMETRIES) + [TOOLS_EXTRA_GEOMETRY]
    records, printed = [], io.StringIO()
    torch.cuda.synchronize()
    reset_launches(fa)
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = validate_kernels.main(geometries, device="cuda", records=records)
    seconds = time.perf_counter() - t
    got = read_launches(fa)
    launches["validate_kernels"] = got
    # one K3 call a geometry and the bf16 check; K1 and K2 where d = 64 and H is even
    pairs = sum(1 for _, H, _, d, _ in geometries if d == 64 and H % 2 == 0)
    last_d = geometries[-1][3]
    sm90 = int(fa.attention_body("attention_headmajor", torch.bfloat16, last_d) == "sm90")
    want = {"attention_fat": pairs, "attention_packed": pairs,
            "attention_headmajor": len(geometries) + 1, "sm90": sm90}
    by_body = {name: {"sm90": got["sm90_by_kernel"].get(name, 0),
                      "common": got[name] - got["sm90_by_kernel"].get(name, 0)}
               for name in KERNELS}
    out = {"rc": rc, "geometries": geometries, "checks": records, "seconds": seconds,
           "launches_by_body": by_body, "expected_launches": want,
           "tol_f32": validate_kernels.CARD_TOL_F32,
           "max_f32_err": max(r["err"] for r in records if "fp64" in r["check"]),
           "printed": printed.getvalue().splitlines()}
    bad = [r for r in records if not r["ok"]]
    if rc != 0 or bad or not records:
        raise AssertionError(f"validate_kernels failed on the card (rc {rc}): {bad}")
    if {name: got[name] for name in want} != want or by_body["attention_headmajor"]["sm90"] != sm90:
        raise AssertionError(f"validate_kernels launched {got}, expected {want}")
    return out


def padded_calls(torch, fa, cfg) -> dict:
    """``calls_launches`` at each of PADDED_CASES, bf16 and fp32, RoPE off
    and on, keyed (N, d, dtype, rope). Taken in phase 2: after phases 8 and
    9 the profiler's traces hold no device events on the card's machine."""
    return {(N, d, str(dtype), rope): calls_launches(
                torch, fa, cfg, B, H, N, d, (16, 16) if N == 261 else (30, 40), dtype, rope)
            for B, N, H, d in PADDED_CASES for dtype in (torch.bfloat16, torch.float32)
            for rope in (False, True)}


def padded_cases(torch, fa, cfg, calls) -> list:
    """K3 at PADDED_CASES' head dims, bf16 and fp32, RoPE off and on: each
    against the plain version at d, timed beside the kernel at the width it
    pads to (on tensors already padded) and SDPA at d, with the kernels one
    call launches (K3's counter, and every CUDA kernel of a profiler trace
    of one call: ``calls``, from :func:`padded_calls`). bf16 at a multiple
    of 8 runs with no copy: one kernel a call, two with RoPE (the prologue,
    then K3)."""
    cases = []
    for B, N, H, d in PADDED_CASES:
        grid = (16, 16) if N == 261 else (30, 40)
        width = fa.padded_head_dim(d)
        for dtype in (torch.bfloat16, torch.float32):
            for rope in (False, True):
                case = kernel_case(torch, fa, cfg, "attention_headmajor", B, H, N, d, grid,
                                   dtype, rope)
                case["body"] = fa.attention_body("attention_headmajor", dtype, width)
                case["padded_to"] = width
                case.update(calls[(N, d, str(dtype), rope)])
                if dtype == torch.bfloat16 and d % 8 == 0:
                    case["ok"] = case["ok"] and case["kernels_per_call"] == 1 + rope and not any(
                        COPY_KERNEL.search(name) for name in case["kernel_names"])
                case["built_width_ms"] = built_width_ms(torch, fa, cfg, B, H, N, d, grid, dtype,
                                                        rope)
                case["phase"] = "kernel_padded"
                emit(case)
                cases.append(case)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K3 at padded widths disagrees with its plain version: {bad}")
    return cases


def wide_odd_cases(torch, fa, cfg) -> list:
    """K3 at WIDE_ODD_CASES' head dims, bf16 and fp32, with RoPE tables:
    each against the plain version at d, timed beside its bound and SDPA at
    d (RoPE applied beforehand)."""
    cases = []
    for B, N, H, d in WIDE_ODD_CASES:
        grid = (16, 16) if N == 261 else (30, 40)
        tables = None
        if d % 4:
            ang = np.random.default_rng(SEED + 11).uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
            tables = tuple(torch.from_numpy(f(ang)).to("cuda") for f in (np.cos, np.sin))
        for dtype in (torch.bfloat16, torch.float32):
            case = kernel_case(torch, fa, cfg, "attention_headmajor", B, H, N, d, grid, dtype,
                               True, tables=tables)
            case["padded_to"] = fa.padded_head_dim(d)
            case["phase"] = "kernel_wide_odd"
            emit(case)
            cases.append(case)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K3 at wide or odd head dims disagrees with its plain version: {bad}")
    return cases


def calls_launches(torch, fa, cfg, B, H, N, d, grid, dtype, rope) -> dict:
    """K3's launches in one call at d (its counter) and the CUDA kernels the
    call ran (a profiler trace), by name."""
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).to("cuda", dtype)
               for _ in range(3))
    cos, sin = rope_full(torch, cfg, d, grid, N, "cuda") if rope else (None, None)
    before = fa.launches_headmajor
    fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin)
    launches = fa.launches_headmajor - before
    names = trace_kernels(torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin))
    return {"k3_launches_per_call": launches, "kernels_per_call": len(names),
            "kernel_names": [name[:120] for name in names]}


def built_width_ms(torch, fa, cfg, B, H, N, d, grid, dtype, rope) -> float:
    """K3's time at the width ``d`` pads to, on tensors padded beforehand
    (no pad or slice in the timed call)."""
    width = fa.padded_head_dim(d)
    rng = np.random.default_rng(SEED)
    q, k, v = (fa.pad_head_dim(torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                               .to("cuda", dtype), width, rope) for _ in range(3))
    cos = sin = None
    if rope:
        cos, sin = (fa.pad_head_dim(t, width, True) for t in rope_full(torch, cfg, d, grid, N, "cuda"))
    return time_ms(torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin))


def attention_map_step(torch, fa, cfg, params, launches) -> dict:
    """``cls_attention_map`` at ``cfg``'s full width and depth on MAP_FRAMES
    frames of 256x256 in bf16 on the card: K1 once a block but the last,
    each launch through the Hopper body; the map against the CPU fp32 run."""
    from cbas_tpu_torch.models.vit import cls_attention_map

    gained = {k: v * MAP_QK_GAIN if k.endswith(("q_proj.weight", "k_proj.weight")) else v
              for k, v in params.items()}
    planes = np.random.default_rng(SEED + 10).integers(0, 256, (MAP_FRAMES, 256, 256), np.uint8)
    x = np.repeat((planes / 255.0).astype(np.float32)[:, None], 3, axis=1)
    card_params = {k: torch.from_numpy(v).to("cuda", torch.bfloat16) for k, v in gained.items()}
    pixels = torch.from_numpy(x).to("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches(fa)
    got = cls_attention_map(card_params, pixels, cfg)
    torch.cuda.synchronize()
    launches["cls_attention_map"] = read_launches(fa)
    want_launches = check_launches("cls_attention_map", launches["cls_attention_map"],
                                   "attention_fat", cfg.num_layers - 1, 1, sm90=True)
    ms = time_ms(torch, lambda: cls_attention_map(card_params, pixels, cfg), iters=5, warmup=1)
    t = time.perf_counter()
    ref = cls_attention_map({k: torch.from_numpy(v) for k, v in gained.items()},
                            torch.from_numpy(x), cfg).numpy()
    cpu_s = time.perf_counter() - t
    got = got.cpu().numpy()
    grid = (256 // cfg.patch_size,) * 2
    a, b = got.reshape(MAP_FRAMES, -1), ref.reshape(MAP_FRAMES, -1)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    uniform_cos = b.sum(1) / (np.sqrt(b.shape[1]) * np.linalg.norm(b, axis=1))
    err = float(np.abs(got - ref).max())
    out = {"model": f"{ENCODER}, full width and depth, q/k weights x{MAP_QK_GAIN}",
           "frames": MAP_FRAMES, "dtype": "bfloat16", "shape": list(got.shape),
           "launches": launches["cls_attention_map"], "expected_launches": want_launches,
           "ms_per_call": ms, "cpu_fp32_s": cpu_s, "max_abs_err": err,
           "max_ref": float(ref.max()), "tol_abs": MAP_ATOL_OF_MAX * float(ref.max()),
           "min_map_cos": float(cos.min()), "tol_min_cos": MAP_MIN_COS,
           "ref_min_cos_to_uniform": float(uniform_cos.min())}
    if got.shape != (MAP_FRAMES, *grid) or not np.isfinite(got).all() \
            or err > out["tol_abs"] or cos.min() < MAP_MIN_COS:
        raise AssertionError(f"cls_attention_map on the card disagrees with the CPU run: {out}")
    return out


def fleet_step(device="cuda", encoder_dir=None, dtype="bfloat16") -> dict:
    """``encode_fleet`` with one worker over FLEET_CLIPS 256x256 clips in a
    fresh project whose encoder is ``encoder_dir`` (default: dinov3-vitb16
    with random weights from SEED, saved as a checkpoint): every H5 stamped
    and equal to an in-process ``encode_file`` on ``device``. (``device`` is
    "cpu" only in the CPU test of this function.)"""
    import shutil

    import h5py
    import torch

    from cbas_tpu_torch.core import hdf5_store
    from cbas_tpu_torch.core.config import dump_yaml
    from cbas_tpu_torch.core.project import Project
    from cbas_tpu_torch.engine.encode import encode_file
    from cbas_tpu_torch.models.encoder import FrameEncoder

    with tempfile.TemporaryDirectory() as d:
        project = Project.create_project(d, "fleet")
        encoder = os.path.join(project.path, "encoder")
        if encoder_dir is None:
            from safetensors.numpy import save_file

            from cbas_tpu_torch.models.vit import PRESETS, init_vit_params

            os.makedirs(encoder)
            with open(os.path.join(encoder, "config.json"), "w") as f:
                json.dump({"model_type": "dinov3_vit", "hidden_size": 768,
                           "num_hidden_layers": 12, "num_attention_heads": 12,
                           "intermediate_size": 3072, "patch_size": 16,
                           "num_register_tokens": 4}, f)
            save_file(init_vit_params(SEED, PRESETS[ENCODER]),
                      os.path.join(encoder, "model.safetensors"))
        else:
            shutil.copytree(encoder_dir, encoder)
        dump_yaml({"encoder_model_identifier": "encoder", "runtime": {"compute_dtype": dtype}},
                  os.path.join(project.path, "cbas_config.yaml"))
        videos = []
        for i in range(FLEET_CLIPS):
            video = os.path.join(project.recordings_dir, "day1", f"m{i}", f"m{i}_00001.mp4")
            os.makedirs(os.path.dirname(video))
            write_clip(video, FLEET_FRAMES, SEED + 20 + i)
            videos.append(video)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "cbas_tpu_torch.tools.encode_fleet", "--project",
               project.path, "--workers", "1"] + (["--force-cpu"] if device == "cpu" else [])
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        fleet_s = time.perf_counter() - t
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode != 0 or not lines or lines[-1].get("still_stale") != 0:
            raise AssertionError(f"encode_fleet failed (rc {proc.returncode}): "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        ident = Project(project.path).encoder_model_identifier
        enc = FrameEncoder(ident, device=device, compute_dtype=getattr(torch, dtype))
        max_diff = 0.0
        for video in videos:
            h5 = video.replace(".mp4", "_cls.h5")
            if not hdf5_store.is_stamp_valid(h5, ident):
                raise AssertionError(f"encode_fleet: {h5} is not stamped by {ident}")
            with h5py.File(h5, "r") as f:
                fleet_rows = f["cls"][:]
            inproc = os.path.join(d, "inproc", os.path.basename(video))
            os.makedirs(os.path.dirname(inproc), exist_ok=True)
            shutil.copyfile(video, inproc)
            with h5py.File(encode_file(enc, inproc), "r") as f:
                rows = f["cls"][:]
            if rows.shape != fleet_rows.shape or not np.array_equal(rows, fleet_rows):
                raise AssertionError(f"encode_fleet: {h5} differs from the in-process encode")
            max_diff = max(max_diff, float(np.abs(rows.astype(np.float32) - fleet_rows).max()))
    return {"clips": FLEET_CLIPS, "frames": FLEET_FRAMES, "workers": 1, "device": device,
            "dtype": dtype, "wall_s": fleet_s, "summary": lines[-1],
            "max_abs_diff_vs_in_process": max_diff, "ok": True}


def soak_step(device="cuda", **soak_kw) -> dict:
    """``run_soak`` with SOAK_CAMERAS cameras for SOAK_MINUTES at full size
    (dinov3-vitb16, bf16, the champion-size live head) on ``device``: segments
    encoded and classified, the actogram drawn, the backlog bounded.
    ``soak_kw`` cuts it down for the CPU test of this function."""
    from cbas_tpu_torch.tools.soak import run_soak

    kw = {"cameras": SOAK_CAMERAS, "minutes": SOAK_MINUTES, **soak_kw}
    r = run_soak(device=device, **kw)
    out = {key: getattr(r, key) for key in (
        "cameras", "minutes", "sustained", "segments_delivered", "segments_encoded",
        "segments_classified", "actograms_generated", "max_queue_depth", "final_queue_depth",
        "encode_fps_avg", "reason")}
    out["device"] = device
    if not (r.segments_delivered >= 2 and r.segments_encoded >= 1 and r.segments_classified >= 1
            and r.actograms_generated >= 1 and r.trace and r.sustained):
        raise AssertionError(f"soak: {out}")
    return out


# 11. The device mesh: one process, one thread per shard. Without a second
# card the shards are logical (cuda:0 listed once per shard), so their
# frames/s record that the sharded path runs, not how it scales.
MESH_LAYOUTS = ((2, 2), (1, 4))  # (data, model) over dinov3-vitb16
# - mesh bf16 vs one device bf16: the same weights and roundings, but each
#   sharded out-projection sums its partials in another order (and rounds
#   them to bf16 apiece), so rows may differ by a few bf16 ulps.
MESH_MIN_COS = 0.999
MESH_7B_MODEL, MESH_7B_FRAMES = 2, 16  # ViT-7B width, 16 heads of 128 a shard
# The shard threads meet at a barrier twice per model-axis sum; a thread that
# wakes there waits for the interpreter lock, which the running thread keeps
# for up to the switch interval (5 ms by default). The first layout is timed
# again at this interval to show how much of the sharded encode that costs.
MESH_SWITCH_INTERVAL_S = 1e-4
MESH_TRAIN_DATA, MESH_TRAIN_RECORDINGS, MESH_TRAIN_FRAMES = 2, 2, 4000
# - a DP train step vs the one-device step on the card, fp32 with TF32 off,
#   dropout on from one seed: the loss within 1e-5 relative, as phase 8.


def mesh_devices(torch, n, real, device="cuda"):
    """``n`` shards: cuda:0 .. cuda:n-1 if ``real``, else ``device`` n times."""
    return [torch.device("cuda", i) if real else torch.device(device) for i in range(n)]


def mesh_launches_check(route, got, kernel, n, device):
    """``kernel`` launched ``n`` times and no other kernel, each through the
    Hopper body (on the CPU the plain versions run and nothing is counted)."""
    return check_launches(route, got, kernel, n, 1, sm90=True) if device == "cuda" else None


def mesh_phase(torch, fa, cfg, enc, planes, one_emb, bundle, one_probs, emb, card,
               real=False, device="cuda") -> tuple:
    """Phase 11 over logical shards of cuda:0, or (``real``) over distinct
    cards: dinov3-vitb16 at full width over each of MESH_LAYOUTS (and the
    first one again with ``CBAS_ATTN_FAT=0``) against the one-device
    encoder's ``one_emb`` for ``planes``, its launches counted per shard;
    the ViT-7B width over model = MESH_7B_MODEL; one DP train step against
    the one-device step; DP inference against ``one_probs``. Returns (the
    launches of the encodes, the phase line). (``device`` is "cpu" only in
    the CPU test of this function, at a cut size.)"""
    from cbas_tpu_torch.engine import train as train_mod
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.parallel.mesh import make_mesh, runtime_mesh

    n_cards = torch.cuda.device_count()
    line = {"phase": "mesh_multi_gpu" if real else "mesh", "card": card,
            "shards": "distinct cards" if real else "logical shards of cuda:0",
            "runtime_mesh": repr(runtime_mesh())}
    print(f"runtime_mesh() on {n_cards} visible card(s): {line['runtime_mesh']}", flush=True)
    if (n_cards < 2) != (line["runtime_mesh"] == "None"):
        raise AssertionError(f"runtime_mesh() on {n_cards} cards gave {line['runtime_mesh']}")
    layouts = [(d, m) for d, m in MESH_LAYOUTS if d * m <= (n_cards if real else 8)]
    if real:
        layouts = layouts or [(n_cards, 1)]
    batch = len(planes)
    runs, total = [], {}
    one_fps = warm_fps(torch, enc, planes, batch, 3)
    for (d, m), fat in [(lay, "1") for lay in layouts] + [(layouts[0], "0")]:
        mesh = make_mesh((d, m), ("data", "model"), mesh_devices(torch, d * m, real, device))
        with env_var("CBAS_ATTN_FAT", fat):
            menc = FrameEncoder(ENCODER, random_init=True, mesh=mesh)
            torch.cuda.synchronize()
            reset_launches(fa)
            got = menc.encode_planes(planes, batch=batch)
            launches = read_launches(fa)
            local = cfg.num_heads // m if cfg.num_heads % m == 0 else cfg.num_heads
            kernel = ("attention_headmajor" if local % 2
                      else "attention_fat" if fat == "1" else "attention_packed")
            want = mesh_launches_check(f"mesh {d}x{m}", launches, kernel,
                                       (cfg.num_layers - 1) * d * m, device)
            cos = row_cosine(got, one_emb)
            run = {"data": d, "model": m, "CBAS_ATTN_FAT": fat, "local_heads": local,
                   "kernel": kernel, "launches": launches, "expected_launches": want,
                   "q_proj_rows_per_shard": [
                       int(menc._shards[0][j].params["layer.0.attention.q_proj.weight"].shape[0])
                       for j in range(m)],
                   "weights_device": menc.weights_device, "min_cos": float(cos.min()),
                   "tol_min_cos": MESH_MIN_COS,
                   "fps": warm_fps(torch, menc, planes, batch, 3), "one_device_fps": one_fps}
            if (d, m) == layouts[0] and fat == "1":
                old_interval = sys.getswitchinterval()
                sys.setswitchinterval(MESH_SWITCH_INTERVAL_S)
                try:
                    run["fps_at_switch_interval"] = warm_fps(torch, menc, planes, batch, 3)
                finally:
                    sys.setswitchinterval(old_interval)
                run["switch_interval_s"] = MESH_SWITCH_INTERVAL_S
        rows = cfg.hidden_size // m if local != cfg.num_heads else cfg.hidden_size
        if got.shape != one_emb.shape or not np.isfinite(got).all() or cos.min() < MESH_MIN_COS \
                or run["q_proj_rows_per_shard"] != [rows] * m:
            raise AssertionError(f"mesh encode {d}x{m} disagrees with one device: {run}")
        runs.append(run)
        for name in KERNELS:
            total[name] = total.get(name, 0) + launches[name]
        del menc
    line["encode"] = runs
    line["fps_note"] = ("logical shards share one card: a correctness record, not scaling"
                        if not real else "distinct cards")
    line["vit7b"] = mesh_vit7b_step(torch, fa, FrameEncoder, make_mesh, real, total, device)
    line["train_step"] = mesh_train_step(torch, train_mod, real, device)
    imesh = make_mesh((MESH_TRAIN_DATA,), ("data",),
                      mesh_devices(torch, MESH_TRAIN_DATA, real, device))
    half = SEQ_LEN // 2
    probs = InferenceSession(bundle, mesh=imesh).predict_frames(emb, pad_front=half,
                                                                pad_back=half)
    err = float(np.abs(probs - one_probs).max())
    line["infer"] = {"data": MESH_TRAIN_DATA, "frames": len(emb), "max_abs_err_vs_one_device": err,
                     "tol": CLASSIFY_TOL}
    if probs.shape != one_probs.shape or err > CLASSIFY_TOL:
        raise AssertionError(f"DP inference disagrees with one device: {line['infer']}")
    line["launches"] = total
    line["ok"] = True
    emit(line)
    return total, line


def mesh_vit7b_step(torch, fa, FrameEncoder, make_mesh, real, total, device="cuda") -> dict:
    """The ViT-7B width (depth VIT7B_DEPTH) over model = MESH_7B_MODEL
    against one device, bf16, MESH_7B_FRAMES frames of 256x256: K3 at 16
    heads of 128 a shard, through the Hopper body."""
    from cbas_tpu_torch.models.vit import config_for_identifier, init_vit_params

    with tempfile.TemporaryDirectory() as ckpt:
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump({**VIT7B_CONFIG, "num_hidden_layers": VIT7B_DEPTH}, f)
        cfg = config_for_identifier(ckpt)
        params = init_vit_params(SEED, cfg)
        one = FrameEncoder(ckpt, params=params, device=device)
        planes = np.random.default_rng(SEED + 12).integers(
            0, 256, (MESH_7B_FRAMES, 256, 256), np.uint8)
        want = one.encode_planes(planes)
        one_fps = warm_fps(torch, one, planes, MESH_7B_FRAMES, 2)
        del one
        mesh = make_mesh((1, MESH_7B_MODEL), ("data", "model"),
                         mesh_devices(torch, MESH_7B_MODEL, real, device))
        menc = FrameEncoder(ckpt, params=params, mesh=mesh)
        del params
        torch.cuda.synchronize()
        reset_launches(fa)
        got = menc.encode_planes(planes)
        launches = read_launches(fa)
        expected = mesh_launches_check("mesh ViT-7B", launches, "attention_headmajor",
                                       (cfg.num_layers - 1) * MESH_7B_MODEL, device)
        cos = row_cosine(got, want)
        out = {"model": f"DINOv3 ViT-7B/16 width, depth {VIT7B_DEPTH}", "model_axis": MESH_7B_MODEL,
               "local_heads": cfg.num_heads // MESH_7B_MODEL, "head_dim": cfg.head_dim,
               "launches": launches, "expected_launches": expected,
               "q_proj_rows_per_shard": int(
                   menc._shards[0][0].params["layer.0.attention.q_proj.weight"].shape[0]),
               "min_cos": float(cos.min()), "tol_min_cos": MESH_MIN_COS,
               "fps": warm_fps(torch, menc, planes, MESH_7B_FRAMES, 2), "one_device_fps": one_fps}
        del menc
        torch.cuda.empty_cache()
    if not np.isfinite(got).all() or cos.min() < MESH_MIN_COS \
            or out["q_proj_rows_per_shard"] != cfg.hidden_size // MESH_7B_MODEL:
        raise AssertionError(f"ViT-7B over model = {MESH_7B_MODEL} disagrees: {out}")
    for name in KERNELS:
        total[name] = total.get(name, 0) + launches[name]
    return out


def mesh_train_step(torch, train_mod, real, device="cuda") -> dict:
    """One train step of the deltas head at the app's width over data =
    MESH_TRAIN_DATA against the one-device step: device-gather path (the
    store replicated on each data device), dropout on from one seed, class
    weights, label smoothing and weight decay; fp32 with TF32 off."""
    from cbas_tpu_torch.engine.data import BalancedSampler, DeviceWindowStore, WindowSource
    from cbas_tpu_torch.models.convert import deltas_params_from_numpy
    from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params
    from cbas_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(SEED + 13)
    dim, half = 768, SEQ_LEN // 2
    arrays = {f"rec{r}": rng.standard_normal((MESH_TRAIN_FRAMES, dim), np.float32)
              .astype(np.float16) for r in range(MESH_TRAIN_RECORDINGS)}
    manifest = [(name, c, int(c // 200) % len(TRAIN_BEHAVIORS)) for name in arrays
                for c in range(half, MESH_TRAIN_FRAMES - half)]
    source = WindowSource(manifest, SEQ_LEN, cache=MemoryCache(arrays), preload=True)
    cfg = DeltasHeadConfig(in_features=dim, out_features=len(TRAIN_BEHAVIORS), seq_len=SEQ_LEN,
                           lstm_hidden_size=HIDDEN)
    params = init_deltas_params(SEED, cfg)
    idx = BalancedSampler(manifest, cfg.out_features, seed=SEED).epoch_indices()
    weights = np.linspace(0.5, 2.0, cfg.out_features).astype(np.float32)
    devices = mesh_devices(torch, MESH_TRAIN_DATA, real, device)
    runs = {}
    with tf32(torch, False, False):
        for name, mesh in (("one", None), ("mesh", make_mesh((MESH_TRAIN_DATA,), ("data",),
                                                             devices))):
            store = DeviceWindowStore(manifest, SEQ_LEN, device, ram=source._ram, mesh=mesh)
            centers, labels = store.batch_indices(idx[:TRAIN_BATCH], TRAIN_BATCH)
            head = deltas_params_from_numpy(params, cfg, device)
            opt = train_mod.make_optimizer(head, TRAIN_LR, STEP_WEIGHT_DECAY, GATE_DECAY)
            step = train_mod.build_train_step(head, opt, weights, 0.1, gather_seq_len=SEQ_LEN,
                                              mesh=mesh)
            gen = torch.Generator(device=device).manual_seed(SEED)
            loss = float(step(store.features, centers, labels, gen))
            runs[name] = (loss, {n: p.detach().cpu().numpy() for n, p in head.named_parameters()})
            del store, head, opt
    (loss_1, new_1), (loss_m, new_m) = runs["one"], runs["mesh"]
    out = {"data": MESH_TRAIN_DATA, "batch": TRAIN_BATCH, "dropout": True, "loss_one": loss_1,
           "loss_mesh": loss_m, "loss_rel_err": abs(loss_m - loss_1) / abs(loss_1),
           "loss_rtol": STEP_LOSS_RTOL,
           "max_weight_diff": max(float(np.abs(new_m[n] - new_1[n]).max()) for n in new_1)}
    if not np.isfinite(loss_m) or out["loss_rel_err"] > STEP_LOSS_RTOL:
        raise AssertionError(f"a DP train step disagrees with the one-device step: {out}")
    return out


if __name__ == "__main__":
    sys.exit(main())
