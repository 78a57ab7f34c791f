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
   with NaN in the dead K/V rows, and the main paths' shapes, timed:
   - K1 (flat) at dinov3-vitb16's 12 heads;
   - K2 (head-pair packed) at its 6 pairs;
   - K3 (head-major) at 32 heads of 128 (DINOv3 ViT-7B), at 3 heads of 64
     (an odd head count), and at head dims 96 and 40;
3. encode, flat route: the main path at the full width of dinov3-vitb16
   (random weights from a numpy seed): 256x256 planes in two full batches
   and a partial one, 640x480 planes in one batch, then the head over the
   embeddings. Kernel launch counts are read around this run: K1 only. Then
   warm frames/s, and accuracy against the port's CPU fp32 run on the same
   weights;
4. classify: probabilities of a deltas head (seq_len 31) against the CPU run;
5. encode, packed route: ``CBAS_ATTN_FAT=0``, one 256x256 batch and one
   640x480 batch through dinov3-vitb16: K2 only, embeddings against the
   flat route's;
6. encode, ViT-7B width: a checkpoint directory whose ``config.json`` has
   DINOv3 ViT-7B/16's published shape with the depth cut, opened through
   ``FrameEncoder``: 256x256 in a full batch and a partial one, 640x480 in
   one batch: K3 only. Warm frames/s, and accuracy against the CPU fp32 run;
7. files: ``encode_file`` -> ``infer_h5`` on a synthetic clip, where h5py,
   pandas and OpenCV are installed (otherwise a line says what is missing).

The line before the last lists each kernel with its launches on its route,
error and times; the last line is ``{"ok": true, "device": {...}}``.
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
            k = re.search(r"attention_(bf16|f32)ILi(\d+)E", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
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
                time_it=True):
    """One fused-attention case on the card against its plain version, in
    the kernel's own layout."""
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
        torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)
        for _ in range(3)
    )
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
        "phase": "kernel", "name": kernel, "B": B, "N": N, "H": H, "head_dim": d,
        "dtype": str(dtype).replace("torch.", ""), "rope": rope, "n_valid": n_valid,
        "max_abs_err": float(err.max()), "tol": tol_text, "ok": ok,
    }
    if time_it:
        out["ms"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid, cos, sin))
        out["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, scale, n_valid, cos, sin))
    return out


def kernel_phase(torch, fa, cfg) -> dict:
    """Every kernel case; returns the main-shape case of each kernel at
    256x256 (the ``kernels`` line's numbers)."""
    g256, g480 = (16, 16), (30, 40)  # patch grids of 256x256 and 640x480
    bf16, f32 = torch.bfloat16, torch.float32
    results, main = [], {}

    def sweep(kernel, H, d, small=((4, 261, g256), (2, 1205, g480)), ropes=(False, True)):
        for B, N, grid in small:
            for dtype in (bf16, f32):
                for rope in ropes:
                    results.append(kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype, rope))
        for dtype in (bf16, f32):
            results.append(
                kernel_case(torch, fa, cfg, kernel, 4, H, 272, d, g256, dtype, True, n_valid=261)
            )

    H = cfg.num_heads
    sweep("attention_fat", H, 64)
    sweep("attention_packed", H, 64)
    sweep("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128,
          small=((2, 261, g256), (1, 1205, g480)))
    sweep("attention_headmajor", 3, 64)  # an odd head count
    for d in (96, 40):  # a half that is no power of two; a dim no multiple of 16
        sweep("attention_headmajor", 4, d, small=((2, 261, g256),), ropes=(True,))
    # The main paths' shapes: ViT-B at batch 128 / 32, ViT-7B width at 32 / 8.
    for kernel, H, d, b256, b480 in (
        ("attention_fat", H, 64, BATCH_256, BATCH_480),
        ("attention_packed", H, 64, BATCH_256, BATCH_480),
        ("attention_headmajor", VIT7B_CONFIG["num_attention_heads"], 128, BATCH_7B_256,
         BATCH_7B_480),
    ):
        main[kernel] = kernel_case(torch, fa, cfg, kernel, b256, H, 261, d, g256, bf16, True)
        results += [main[kernel],
                    kernel_case(torch, fa, cfg, kernel, b480, H, 1205, d, g480, bf16, True)]
    for r in results:
        emit(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused attention disagrees with its plain version: {bad}")
    return main


def reset_launches(fa) -> None:
    fa.launches = fa.launches_packed = fa.launches_headmajor = 0


def read_launches(fa) -> dict:
    return {"attention_fat": fa.launches, "attention_packed": fa.launches_packed,
            "attention_headmajor": fa.launches_headmajor}


def check_launches(route, got, kernel, per_forward, forwards) -> dict:
    """The route launched ``kernel`` ``per_forward`` times a forward, and no
    other kernel."""
    want = {name: 0 for name in KERNELS}
    want[kernel] = per_forward * forwards
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
    want_flat = check_launches("flat", flat_launches, "attention_fat", per_forward, forwards)
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
            "packed", packed_launches, "attention_packed", per_forward, pf_256 + pf_480
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

    # 7. files end to end, where the host has what the file path needs
    missing = []
    for mod in ("h5py", "pandas", "cv2", "yaml"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        emit({"phase": "files", "skipped": f"not installed: {', '.join(missing)}"})
    else:
        emit(files_phase(enc, bundle))

    route_launches = {
        "attention_fat": flat_launches, "attention_packed": packed_launches,
        "attention_headmajor": vit7b_launches,
    }
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": route_launches[name][name],
        "max_abs_err": main_cases[name]["max_abs_err"],
        "ms": main_cases[name]["ms"], "plain_ms": main_cases[name]["plain_ms"],
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
            "head-major", launches, "attention_headmajor", cfg.num_layers - 1, fwd_256 + fwd_480
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


def files_phase(enc, bundle) -> dict:
    """encode_file -> infer_h5 on a synthetic 256x256 clip (moving gradient
    plus noise), checked by row counts, stamp and probability sums."""
    import cv2
    import h5py
    import pandas as pd

    from cbas_tpu_torch.engine.encode import EncodeConfig, EncodeStats, encode_file
    from cbas_tpu_torch.engine.infer import InferenceSession

    n_frames, size = 200, 256
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cam_00001.mp4")
        rng = np.random.default_rng(SEED)
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (size, size))
        yy, xx = np.mgrid[0:size, 0:size]
        for t in range(n_frames):
            frame = (((xx + 2 * t) % 256 + (yy + t) % 128) % 256).astype(np.uint8)
            noise = rng.integers(0, 30, (size, size), np.uint8)
            w.write(cv2.merge([frame, cv2.add(frame, noise), frame]))
        w.release()
        stats = EncodeStats()
        h5 = encode_file(enc, path, config=EncodeConfig(chunk_frames=BATCH_256), stats=stats)
        with h5py.File(h5, "r") as f:
            rows = f["cls"].shape[0]
            stamp = f.attrs.get("encoder_model_identifier")
        csv = InferenceSession(bundle, device="cuda").infer_h5(h5)
        probs = pd.read_csv(csv).to_numpy()
    ok = (
        rows == stats.frames and probs.shape == (rows, len(bundle.behaviors))
        and stamp == enc.identifier and float(np.abs(probs.sum(1) - 1).max()) <= 1e-5
    )
    if not ok:
        raise AssertionError(f"files phase: rows={rows} stamp={stamp} probs={probs.shape}")
    return {"phase": "files", "frames": rows, "encode_fps": stats.fps, "ok": True}


if __name__ == "__main__":
    sys.exit(main())
