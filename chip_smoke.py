#!/usr/bin/env python3
"""Drive cbas_tpu_torch's serving paths once on a CUDA card and check them.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, one JSON line each (a failed check raises, so the script exits
non-zero and prints no final line):

1. environment: torch/CUDA versions, the card's name and power limit, and a
   fresh build of every kernel from ``cbas_tpu_torch/csrc`` (one nvcc per
   source, started together: the three attention kernels, the LayerNorm,
   the memory floor, the attention body's stage variants, the batched
   attention and the relayout), with each kernel's registers and spills;
2. kernel: first the memory floor (``ops/memory_floor.py``, ``o = q + 0*k
   + 0*v``, replacing probe14's and probe15's ``dma_kernel``) against its
   plain version, bit for bit where the result is a number and NaN where it
   is NaN (Inf and NaN in k and v, -0 in q), at probe14's own (384*6, 272,
   128) bf16 blocks and its flat (rows, 128) form, then at the bytes of
   every timed attention and LayerNorm row below, each timed beside its
   bound at the peak memory rate and ``out.copy_(q)`` (the card's copy
   rate), its launches counted over this phase alone; every timed case
   below reports the floor at its own bytes ("floor_ms"); then probe15's
   chained floor (``floor_chain``): the floor, K2 with RoPE, the plain
   torch sum q + k 1e-3 + v 1e-3 and SDPA (K2's yardstick), each as a CUDA
   graph of 1 and of 5 data-dependent applications at probe15's (384, 6,
   272, 128) blocks (the port's graphs' results bit for bit the eager
   chain's), the marginal cost of an
   application (t5 - t1) / 4, its GB/s over probe15's bytes and one eager
   call beside it. Then each fused
   attention against its plain PyTorch version on the
   card, bf16 and fp32, RoPE on and off, N = 261 and 1205, ``n_valid`` < N
   (272 / 261 and 1216 / 1205) with NaN in the dead K/V rows, and the main
   paths' shapes:
   - K1 (flat) at dinov3-vitb16's 12 heads;
   - K2 (head-pair packed) at its 6 pairs, on contiguous tensors and on
     head-pair views of flat ones (the packed route's operands);
   - K3 (head-major) at 32 heads of 128 (DINOv3 ViT-7B), at 3 heads of 64
     (an odd head count), at head dims 96 and 40, at the small widths 8,
     16, 24 and 32 and the odd 13 (in bf16 8, 24 and 13 staged at 64; fp32
     13 padded to 16), and at head dims 192 and
     256, wider than any shipped preset's heads (timed at 16 heads); and on
     head-major views of flat tensors (the head-major route's operands) at
     d 64, 128, 192, 256 and 320, N 261, 329 and 1205 and 272 / 261 and
     329 / 300, each view case also bit for bit against the kernel on
     contiguous copies;
   - all three on views of one fused (B, N, 3*H*d) q|k|v projection (the
     operands every encode route passes since the projection is one GEMM):
     K1 on its column blocks, K2 and K3 on their head-pair and head-major
     views, small cases of every body (K3 at d 40, 64, 128, 160, 192, 256 and
     320) with NaN in the dead rows, the output dense in q's dim order and
     bit for bit the kernel's on contiguous copies; then at
     dinov3-vitb16's (128, 261, 12, 64) and (32, 1205, 12, 64), and K3
     also at the ViT-7B width's (32, 261, 32, 128) and (8, 1205, 32, 128),
     timed with RoPE and without beside the same call on contiguous
     tensors, the bound, the floor and SDPA.
   bf16 at head dim 64 (and K3's every d up to 192, at the next of 64, 96,
   128, 160 and 192; a d % 16 != 0 through its staging launch) runs the
   Hopper body (``attention_body``), K3's bf16 d from 193 to 256 the
   two-consumer body (``attention_sm90_ws.cuh``, at 224 or 256; only a d %
   8 != 0 staged), fp32 at 64 and 128 its fp32 counterpart
   (``attention_sm90_tf32.cuh``: 3xTF32 on wgmma, with a prologue that splits
   K and V; K3's other fp32 multiples of 4 up to 128 too, its wide form
   ``attention_sm90_tf32_wide.cuh`` from 132 to 256 and its slices body
   ``attention_sm90_tf32_slices.cuh`` above 256); each case checks that the
   call launched its entry once, counted the launch under the body it
   names and, where it stages, one staging launch, and names the
   registers and spills of the kernel it ran (``-Xptxas -v``). At the main
   shapes (K2: on both inputs) each
   kernel is timed with RoPE and without, beside its plain version, its
   bound (FLOP and bytes over the card's peaks) and
   ``scaled_dot_product_attention`` on the same data (head-major, RoPE
   applied beforehand; the backend it picked is named by its kernels in a
   profiler trace). K1, K2 (views) and K3 (views, d 64 and 128) are also
   timed in fp32 at the main shapes, the fp32 Hopper body
   (``runtime.compute_dtype: float32``). Then the tf32 phase
   (``tf32_phase``, the counts set to 0 before it and read after): that
   body's prologue alone (``fa.tf32_prologue``) bit for bit against its
   plain version at K1's and K3's main shapes on views of one fused
   projection, RoPE on and off, and at 272 / 261 with NaN in the dead rows,
   timed beside its byte bound and the floor. Then the LayerNorm kernel
   (``ops/layernorm.py``, fused with the residual add and layer scale)
   against its plain version: the residual bit for bit, y within
   LN_STAT_REL's bound, at the main paths' shapes (rows, D) = (33408, 768),
   (38560, 768), (8352, 4096) and (9640, 4096) in bf16, fused,
   single-pass; at the first also the
   LayerNorm alone, two-pass, fp32 and the CLS rows read in place through
   their row stride; the outlier rows of ``tools/validate_kernels.py`` in
   every mode; an fp32 affine on bf16 x; D 64, 100, 127, 384, 1536, 2560,
   3001 and 20480 (one warp a row, one element a lane at a time, several
   warps a row, and the streamed rows); every case timed beside its byte
   bound, ``x + h * lam`` then ``F.layer_norm``, and the plain version.
   Between the two, the stage phase (``stage_phase``, the variants' launch
   counts set to 0 before it and read after): the compile-time variants of
   the Hopper body (``ops/attention_variants.py``, ``csrc/
   attention_variants.cu``; probe2.py's dma, qk, nosm and pipe bodies and
   probe4.py's vext with and without a bf16 exponential) at the probes' own
   packed (320, 6, 1216, 128) blocks with 1205 live rows (inputs x 0.3,
   random tables, NaN in the dead k and v rows) and at the main paths'
   fused-view shapes (K1 (128, 261, 12, 64) and (32, 1205, 12, 64), K3 (32,
   261, 32, 128) and (8, 1205, 32, 128)), RoPE on and off: dma bit for bit
   q, pipe bit for bit variant 0 (K1, K2 or K3 on the same inputs), qk,
   nosm, vext and vext_bf16exp within ``stage_tolerance``'s bounds of their
   plain versions (the vext forms' run the kernel's own loop; the card's
   ``ex2.approx.ftz.bf16x2`` is first read at every bf16 input,
   ``ex2_deviation``); each timed between two reads of variant 0 (variant 0,
   variant, variant, variant 0) beside the floor, the bound and SDPA, the
   SM clock, power draw, temperature and clock-event reasons sampled around
   each case (``gpu_clocks``), and variant 0's time
   split into stages (dma - floor, qk - dma, nosm - qk, full - nosm, full -
   vext, full - vext_bf16exp);
   Then the batched phase (``batched_phase``, the two kernels' launch counts
   set to 0 before it and read after): the batched whole-row attention
   (``ops/attention_batched.py``, ``csrc/attention_batched.cu``: an item's
   whole K and V resident, an exact softmax, items batched a block) in the
   option set of each head-major batched probe body, at the probe's own
   shape: probe13's qk_kernel (packed blocks) and qk_batched_kernel (bit for
   bit q) and full_batched_kernel (RoPE outside, and without; probe16's is
   the same body) at (384, 12, 272 / 261, 64); probe21's kernel (RoPE
   inside) on head-major views of one fused projection at (384, 12, 261,
   64) with the model's tables; probe26's batched, batched_kt (K
   transposed) and fatq_kt (flat q, K and V transposed) at (448, 12, 272 /
   261, 64); probe26b's gbbatch at gb 4 (RoPE on and off) and gb 8 (RoPE),
   flat; NaN in the dead k and v rows; each within ``batched_tolerance`` of
   its plain version, timed between two reads of K3 (K2 for packed blocks,
   K1 for flat inputs) beside its bound, the floor, SDPA with the key mask
   (q . k^T by torch.matmul for the qk stage), the plain version and the
   same call at one block an SM; probe13's dma_kernel is the floor phase's
   (384*6, 272, 128) case. Then probe26's relayout (``ops/relayout.py``,
   ``csrc/relayout.cu``) at (448, 272, 768), bit for bit, beside the
   permute made contiguous and the floor; and probe21's model A/B:
   dinov3-vitb16 at 256x256 and batch 128 through the port's _attention (K1)
   and with ``batched_attention`` swapped in (11 batched launches a forward,
   embeddings at cosine >= 0.999 of the K1 route's, frames/s in the order
   K1, batched, batched, K1);
   Then the pvt phase (``pvt_phase``, the kernel's launch counts set to 0
   before it and read after): the streamed transposed-score attention
   (``ops/attention_pvt.py``, ``csrc/attention_pvt.cu``: the keys streamed
   through a ring, an exact softmax down the key axis in two passes) in the
   option set of each transposed-score probe body at the probes' packed
   (320*6, 1216, 128) blocks with 1205 live rows (NaN in the dead k and v
   rows, inputs x 0.3, standard normal tables): probe3's std at gp 8 and 4,
   probe5's rounded and vext forms with and without the bf16 exponential
   (vext+bf16exp at gp 4 and 8), probe4's vext with bf16exp off (gp 4) and
   on (gp 4 and 8); each within ``pvt_tolerance`` of its plain version,
   timed between two reads of K2 on the same blocks with RoPE, beside its
   bound, its blocks and waves, the same call at one wave of the card, the
   plain version, the floor and SDPA with the key mask, with its max abs
   difference from K2; probe6's ten interleaved rounds against K2 (the
   median ratio); and probe23's model A/B at 640x480: dinov3-vitb16 at batch
   320 and dinov3-vitl16 at batch 96 (full width and depth, random weights)
   through K1 and with ``pvt_attention`` swapped in (L - 1 launches a
   forward, embeddings at cosine >= 0.999 of K1's, frames/s K1, pvt, pvt,
   K1); and probe23's call alone (``pvt_model_call``) at dinov3-vitb16's
   (320, 12, 1205, 64) on views of one fused projection with the model's
   tables, against its plain version, timed between two reads of K3 beside
   its bound, the floor and SDPA;
3. encode, flat route: the main path at the full width of dinov3-vitb16
   (random weights from a numpy seed): 256x256 planes in two full batches
   and a partial one, 640x480 planes in one batch, then the head over the
   embeddings. Kernel launch counts are read around this run: K1 only, each
   through the Hopper body, the LayerNorm kernel 2L + 1 = 25 times a
   forward, and, by ``models/vit.py``'s own counter, one q|k|v projection
   GEMM a full block and one k|v GEMM (beside the CLS row's q) in the CLS
   block (every encode phase below checks its route's 2L + 1 and its
   projections; a profiler trace of one warm forward records its kernels
   beside the 227 of the forward with three projection GEMMs a block).
   Then
   warm frames/s, and accuracy against the port's CPU fp32 run on the same
   weights; the fp32 encoder's warm frames/s, and a ``torch.profiler`` trace
   of one fp32 batch at each geometry in a process of its own
   (``fp32_trace``: kernels summed by ``chip_ab.py``'s KERNEL_GROUPS);
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
   packed routes' fp32 runs, checked a forward: each through the fp32
   Hopper body with one launch of its prologue), and the fp32 encoder's
   warm frames/s;
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
9b. shell: the backend as the port's desktop shell starts it
   (``cbas_tpu_torch/shell/main.js``'s ``BACKEND_ARGS``, no ``--device``,
   from the repository root, in a session of its own): its ready line
   (``READY_RE``), ``get_cbas_status`` before any project, ``load_project``
   on a copy of the demo project (recordings emptied where h5py is missing)
   with the encoder then on cuda, ``GET /`` serving the frontend's page, and
   SIGTERM to its process group, as the shell's ``stopBackend`` sends it:
   the backend exits within 30 s and leaves no process of its group;
9c. demo: ``cbas_tpu_torch/examples/end_to_end_demo.py`` on the card in a
   temporary directory (its seconds and two mean probabilities, each above
   0.5), where h5py, pandas, OpenCV, matplotlib and scikit-learn import,
   else a line naming what is missing;
10. tools: ``tools/validate_kernels.py`` on the card at its geometries plus
    TOOLS_FP32_GEOMETRIES (K3 at d 192, 256, 200, 320 and 384) and (2, 32,
    261, 128) with RoPE (K1, K2 and K3 in fp32 against an fp64 oracle, each
    through the fp32 Hopper body, its wide form or, at 320 and 384, its
    slices body, then K3 in bf16 at d = 128
    through the Hopper body against
    unfused bf16, and the LayerNorm kernel in bf16 on outlier rows,
    single-pass against two-pass and two-pass against float64), each error
    beside its tolerance and each kernel's launches by body; K3 at head dims
    between its builds (100, run at 128: staged in bf16, maps at d in fp32;
    136, 160, 200 and 248, run in bf16 at 160, 160, 224 and 256, 136 staged,
    in fp32 at 192 or 256), bf16 and fp32, in bf16 at
    ``BF16_WIDTH_CASES`` (32 and 96 at N 261 and 1205, 150 at 1205), RoPE
    on and off, and in fp32 (8, 261, 16, 192 / 256), (4, 1205, 16, 192 /
    256) and (8, 261, 16, 16 / 32), against the plain version at d, timed
    beside the built width and SDPA at d, with K3's and its body's launches,
    the CUDA kernels of one call (a profiler trace: bf16 at a multiple of
    16 runs one kernel, two with RoPE; at any other d two, the staging pass
    and K3; fp32 two, the prologue and K3; no copy kernel) and the SM
    clock; ``models/vit.py::cls_attention_map`` at dinov3-vitb16 (full
    width and depth, q/k weights x4 so the map is far from uniform) on 8
    frames of 256x256 in bf16, 11 K1 launches a call through the Hopper
    body, against the CPU fp32 run; and, where h5py, pandas, OpenCV and
    matplotlib import, ``tools/encode_fleet.py`` with one worker over two
    clips (its H5s against an in-process ``encode_file``) and
    ``tools/soak.py`` with two cameras for half a minute at full size
    (otherwise a ``skipped`` entry names what is missing; the fleet's
    encodes both at FLEET_THREADS intra-op threads). Before the padded
    widths, K3 in bf16 at the cuda tests' set for the widths between the
    builds and the two-consumer body (``ws_cases_step``: d 96, 136, 160,
    192, 200, 224, 232, 248 and 256, N 261 and 1205 and 272 / 261 and 1216
    / 1205 with NaN in the dead rows, RoPE on and off, contiguous and fused
    views), each against the plain version, its launches counted by body
    name: the two-consumer body from 200 up, the Hopper body (the measured
    rule) at the others, no staging launch at 200, 232 and 248 (rows off 32
    bytes read in place). Then K3 at the
    head dims it refused on the card before: (8, 261, 16, 320) and (4, 1205,
    8, 384) on the wide body in bf16 and the fp32 slices body in fp32, (8,
    261, 16, 65) with RoPE tables, bf16 (the staging launch ropes it) and
    fp32 (roped in torch first), and in fp32 (2, 272, 4,
    301) with 261 live keys, NaN in the dead rows (the slices body without
    the TMA), each against the plain version and timed beside its bound and
    SDPA, the slices body's cases also with their slices, the FLOP of the
    scores formed again a slice, and its prologue timed beside its byte
    bound; the padded, wide and odd cases name the body they ran and its
    registers;
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
12. wide heads: encoders of 8 heads of 96, 100, 192, 224, 256 and 320 at
    depth 2 (random weights, opened from a checkpoint directory's
    config.json), 32 frames of 256x256 in bf16 each: K3 once a forward
    through the Hopper body at 96 (its own build), 100 (at 128, with one
    staging launch a forward) and 192, the two-consumer body at 224 and 256
    and the wide body at 320
    (the counts set to 0
    before each run and read after it), a profiler trace of one forward
    with no copy kernel next to K3, embeddings against the CPU fp32 run;
    then K3 alone at the shape each encode gave it, against its plain
    version and timed, and at 100 the staging pass alone, bit for bit its
    plain version;
    at 192, 256 and 320 the encoder again in fp32 on 2 frames, K3 through
    the fp32 Hopper body's wide form (its slices body at 320) with one
    launch of their prologue a forward, embeddings within 1 fp16 ulp + 1e-4
    of the CPU fp32 run, and K3 alone in fp32 at that shape.

The line before the last lists each kernel with its launches on its route,
error, times, bound, registers and the library call's time (K2 and K3 on
views, their routes' inputs, with their times on contiguous tensors beside;
each also in fp32, with its launches of one fp32 forward; K3 also at head
dims 192 and 256, at phase 10's padded, wide and odd widths, with their
launches counted over the encode routes' runs and phase 12's), the launches
of phase 10's runs, and its launches over phase 11's mesh encodes
(``launches_mesh``) and (``fused_views``) its cases on views of one fused
projection beside the same call on contiguous tensors, then K3's
two-consumer body (``attention_sm90_ws.cuh``) as an entry of its own, its
launches those of phase 12 (one a forward at 256), its numbers those of
phase 12's kernel case at 256, with ptxas's report of each build of it
(registers at entry, no spill, no "setmaxnreg ignored") and phase 10's
cases, then K3's wide body
(``attention_wide.cuh``, bf16) as an entry of its own, its launches those
of phase 12 and its numbers those of phase 12's kernel case at d 320, then
bf16's staging pass (``stage_rows``) with its launches over phase 12's
encodes and its numbers at phase 12's d 100, phase 10's staged cases
beside them, then
the fp32 Hopper body
(``attention_sm90_tf32``) with its launches on the fp32 forwards, its
numbers at K1's 256x256 shape and every fp32 main-shape case,
and its prologue (``split_kv``) with its launches and the tf32 phase's
numbers, then its wide form (``attention_sm90_tf32_wide``) with its
launches over phase 12's fp32 encodes, its numbers at phase 12's fp32 case
at d 256 and phase 10's fp32 cases on it, then its slices body
(``attention_sm90_tf32_slices``) with its launches over phase 12's fp32
encode at 320, its numbers at that encode's shape and phase 10's fp32
cases above 256, and the LayerNorm kernel (``layernorm``,
replacing ``benchmarks/attn_probes/probe25_ln_256.py:51``) with its
launches on every route, its numbers at (33408, 768) and its other timed
cases, and the memory floor (``memory_floor``, replacing probe14's and
probe15's ``dma_kernel``) with its launches over the floor phase, its
numbers at probe14's blocks and at every other row, and the stage variants
(``attention_variants``, replacing probe2.py's ``make_variant`` bodies and
probe4.py's ``vext_kernel``) with their launches over the stage phase, pipe's
numbers at K1's 256x256 shape with RoPE, every variant's there, and each
case's times and split, and the batched kernel (``attention_batched``,
replacing the head-major batched probes' bodies) with its launches over the
batched phase by option set, probe21's case with RoPE inside as its numbers,
every case's and the model A/B, and the relayout (``relayout``, replacing
probe26's relayout_kt_kernel), and the streamed transposed-score kernel
(``attention_pvt``, replacing the transposed-score probes' bodies) with its
launches over the pvt phase by option set, probe3's gp 8 case as its
numbers, every case's, probe6's rounds and the model A/Bs; the memory
floor's entry carries probe15's chain; the last line is
``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
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
# 12. These widths, two below 128 and one above 256 through the encoder:
# checkpoint directories whose config.json has 8 heads of 96, 100, 192, 224,
# 256 and 320 (hidden 768, 800, 1536, 1792, 2048 and 2560, gated MLP twice
# the hidden width, the ViT-7B config's other fields) at depth 2, random
# weights from SEED. No public DINO checkpoint has such heads: this drives
# K3's Hopper body at its 96 build, through its staging launch at 100 (at
# 128; the model's tables: 100 % 4 == 0) and at 192, its two-consumer body
# at 224 and 256, and its wide body, through FrameEncoder as a checkpoint of
# that shape would.
WIDE_ENCODER_HEAD_DIMS = (96, 100, 192, 224, 256, 320)
WIDE_ENCODER_HEADS, WIDE_ENCODER_DEPTH = 8, 2
# Also run in fp32: the fp32 Hopper body's wide form at 192 and 256, its
# slices body at 320.
WIDE_ENCODER_FP32_HEAD_DIMS = (192, 256, 320)
WIDE_ENCODER_FRAMES = 32
# K1, K2 and K3 on views of one fused (B, N, 3*H*d) q|k|v projection, the
# operands every encode route hands them since the projection is one GEMM,
# timed at these (B, N, H, d) beside the same call on contiguous tensors and
# SDPA: dinov3-vitb16 at 256x256 / 128 and 640x480 / 32 (all three), and the
# ViT-7B width at 256x256 / 32 and 640x480 / 8 (K3).
FUSED_SHAPES = ((BATCH_256, 261, 12, 64), (BATCH_480, 1205, 12, 64))
# The CUDA kernels of one warm forward (H2D copy included, no D2H) of the
# forward with three projection GEMMs a block, before they were fused, by
# the same kind of trace (``chip_ab.py``; PERF.md §5), at dinov3-vitb16
# 256x256 / 128 and the ViT-7B width at depth 4, 256x256 / 32. Recorded
# beside the fused forward's count, not required.
UNFUSED_KERNELS_A_FORWARD = {"vitb16": 227, "vit7b_depth4": 101}
FUSED_SHAPES_7B = ((BATCH_7B_256, 261, 32, 128), (BATCH_7B_480, 1205, 32, 128))

# The three kernels (source cbas_tpu_torch/csrc/<name>.cu) and the TPU kernel
# each replaces.
# The card's peaks (NVIDIA's H100 SXM data sheet, dense): the bound of a
# kernel is the larger of its FLOP over the rate of its inputs' type and its
# bytes (each input read once, each output written once) over the memory
# rate. bf16 runs on the tensor cores at PEAK_BF16_FLOPS. fp32 attention is
# counted at the 3xTF32 rate, PEAK_TF32_FLOPS / 3: three TF32 products on the
# tensor cores give an fp32-accurate one (attention_sm90_tf32.cuh), so the
# card can do the fp32 work that fast, above the 67 TFLOP/s of its fp32 FMA
# pipes, which a tensor-core body beats (its share of an FMA bound would
# read over 100%).
PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_PER_S = 989e12, 495e12, 3.35e12
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3
KERNELS = {
    "attention_fat": "cbas_tpu/ops/flash_attention.py:553",
    "attention_packed": "cbas_tpu/ops/flash_attention.py:101",
    "attention_headmajor": "cbas_tpu/ops/flash_attention.py:35",
}
# The row LayerNorm (source cbas_tpu_torch/csrc/layernorm.cu), fused with the
# residual add and layer scale before it, and the TPU kernel it replaces. Its
# launches are counted on every route beside the attention kernel's: 2L + 1
# a cls-only forward of L blocks (block 0's norm1 alone, then two fused sites
# a block), 2L - 1 a cls_attention_map call.
LN_KERNEL, LN_REPLACES = "layernorm", "benchmarks/attn_probes/probe25_ln_256.py:51"
# Its cases on the card, (rows, D): the main paths' shapes (dinov3-vitb16 at
# 256x256 batch 128 and 640x480 batch 32; the ViT-7B width at 32 and 8), each
# timed; then small ones for the other paths through the kernel (rows, D,
# what they cover).
LN_MAIN_SHAPES = ((BATCH_256 * 261, 768), (BATCH_480 * 1205, 768),
                  (BATCH_7B_256 * 261, 4096), (BATCH_7B_480 * 1205, 4096))
LN_SMALL_SHAPES = ((300, 64, "bf16: one warp a row, one chunk a lane"),
                   (300, 100, "D no multiple of 8: one element a lane at a time"),
                   (200, 127, "odd D: one element a lane at a time"),
                   (261, 384, "bf16: one warp a row"), (261, 1536, "bf16: two warps a row"),
                   (97, 2560, "bf16: four warps a row"), (33, 3001, "streamed: odd D over 2048"),
                   (9, 20480, "streamed: over 16384 elements in bf16"))
LN_EPS = 1e-5  # dinov3's layer_norm_eps
# The memory floor (source cbas_tpu_torch/csrc/memory_floor.cu): o = q + 0*k
# + 0*v, the bytes of one attention call (q, k and v read, o written) with
# none of its arithmetic. It replaces the TPU kernel dma_kernel of three probe
# sites; its own path is the floor phase, run with the counts set to 0 before
# it and read after it.
FLOOR_KERNEL = "memory_floor"
FLOOR_REPLACES = "benchmarks/attn_probes/probe14_dma_floor_256.py:40"
FLOOR_SITES = ("benchmarks/attn_probes/probe14_dma_floor_256.py:51",
               "benchmarks/attn_probes/probe14_dma_floor_256.py:63",
               "benchmarks/attn_probes/probe15_marginal_256.py:50",
               "benchmarks/attn_probes/probe18_fat768_256.py:107",
               "benchmarks/attn_probes/probe18b_unroll_256.py:158")
# Its cases, (label, shape, dtype): the probes' own, (B*G, N, 128) bf16 blocks
# of probe14's make_dma and probe15's f_dma and the same bytes flat (probe14's
# make_dma_flat2d); then the bytes of each timed attention row (four (B*N,
# H*d) tensors) and LayerNorm row (x and h read, x' and y written: four
# (rows, D) tensors; the LayerNorm alone: half of that) of PERF.md, so each
# row's bound at the peak rate has its measured floor beside it. probe18's
# and probe18b's dma_kernel (:102, :153) run at flat (B, N, 768) blocks.
FLOOR_SHAPES = (("probe14/15 blocks (B*G, N, 128)", (384 * 6, 272, 128), "bfloat16"),
                ("probe14 flat2d (rows, 128)", (384 * 6 * 272, 128), "bfloat16"),
                ("probe18/18b flat (B, N, 768)", (384, 272, 768), "bfloat16"))


# The stage variants of the Hopper attention body (source
# cbas_tpu_torch/csrc/attention_variants.cu, compile-time variants of
# attention_sm90.cuh's loop): probe2.py's make_variant with its four bodies
# (dma_kernel, qk_kernel, nosm_kernel, pipe_kernel) and probe4.py's
# make_variant with vext_kernel (bf16exp off and on). Their own path is the
# stage phase, run with their counts set to 0 before it and read after it.
VARIANTS_KERNEL = "attention_variants"
VARIANTS_REPLACES = "benchmarks/attn_probes/probe2.py:45"
VARIANTS_SITES = tuple(f"benchmarks/attn_probes/{site}" for site in (
    "probe2.py:63", "probe2.py:67", "probe2.py:95", "probe2.py:126", "probe4.py:46",
    "probe4.py:64"))
# Its cases, (label, layout, B, N, H, d, n_valid, patch grid): the probes' own
# packed (320 * 6, 1216, 128) blocks with 1205 live rows, probe-like inputs
# (standard normal x 0.3, random tables from a seed; grid None), then the main
# paths' shapes on views of one fused projection with the model's tables, as
# kernel_case builds them: K1 at dinov3-vitb16's, K3 at the ViT-7B width's.
# Each with RoPE and without.
STAGE_CASES = (
    ("probe2/probe4 blocks", "packed", 320, 1216, 12, 64, 1205, None),
    ("K1 vitb16 256x256", "fat", BATCH_256, 261, 12, 64, 261, (16, 16)),
    ("K1 vitb16 640x480", "fat", BATCH_480, 1205, 12, 64, 1205, (30, 40)),
    ("K3 ViT-7B width 256x256", "headmajor", BATCH_7B_256, 261, 32, 128, 261, (16, 16)),
    ("K3 ViT-7B width 640x480", "headmajor", BATCH_7B_480, 1205, 32, 128, 1205, (30, 40)),
)
# The kernels line's headline: this case (index into STAGE_CASES), with RoPE,
# and this variant (the full function).
STAGE_HEADLINE = (1, "pipe")
STAGE_PROBE_INPUT_SCALE = 0.3  # probe2.py / probe4.py: standard normal x 0.3


def floor_rows() -> tuple:
    """FLOOR_SHAPES, then (label, shape, dtype) at the bytes of every timed
    attention and LayerNorm row."""
    attention = [(BATCH_256, 261, 12, 64), (BATCH_480, 1205, 12, 64),
                 (BATCH_7B_256, 261, 32, 128), (BATCH_7B_480, 1205, 32, 128)]
    rows = [(f"attention {B}x{N}x{H}x{d}", (B * N, H * d), dt) for B, N, H, d in attention
            for dt in ("bfloat16", "float32")]
    others = [(BATCH_7B_256, 261, WIDE_HEADS, d) for d in WIDE_HEAD_DIMS]
    others += [(B, N, H, d) for B, N, H, d in
               PADDED_CASES + TF32_WIDE_CASES + TF32_SMALL_CASES + WIDE_ODD_CASES]
    others += [(B, N, H, d) for B, N, H, d, _ in WIDE_ODD_FP32_CASES]
    others += [(WIDE_ENCODER_FRAMES, 261, WIDE_ENCODER_HEADS, max(WIDE_ENCODER_HEAD_DIMS))]
    rows += [(f"attention {B}x{N}x{H}x{d}", (B * N, H * d), dt) for B, N, H, d in others
             for dt in ("bfloat16", "float32")]
    ln = [(f"layernorm {r}x{D} fused", (r, D), "bfloat16") for r, D in LN_MAIN_SHAPES]
    r, D = LN_MAIN_SHAPES[0]
    ln += [(f"layernorm {r}x{D} alone", (r, D // 2), "bfloat16"),
           (f"layernorm {r}x{D} fused", (r, D), "float32")]
    return FLOOR_SHAPES + tuple(dict.fromkeys(rows)) + tuple(ln)
# - LayerNorm kernel vs its plain version on the card: the residual stream
#   bit for bit (both round h * lambda, then the sum, to x's dtype). y: both
#   sum the statistics in fp32 in different orders, each sum rounded at most
#   about 64 times on either side at these widths, so the fp32 y may differ
#   by 128 fp32 ulps (2^-17) relative to the terms: |y - b| (through rstd)
#   and |w| rstd mean|x'| (through the mean), times kappa = E[x'^2] / var
#   for the single-pass variance (its cancellation; 1 for two-pass); then
#   one ulp of the output dtype for the final rounding.
LN_STAT_REL = 2.0 ** -17

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


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line on stdout; on stderr the seconds since the script
    started and the line's phase, so a run's time splits by phase."""
    print(json.dumps(obj), flush=True)
    print(f"[{time.perf_counter() - _START:.1f} s] {obj.get('phase', 'result')}", file=sys.stderr,
          flush=True)


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


def dtype_ulp(torch, x, bits: int = 8):
    """One ulp at |x| of a float type with ``bits`` significant bits (8:
    bf16, 24: fp32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - (bits - 1))


def build_all(_cuda) -> dict:
    """Build every kernel's library at once (one nvcc each, in parallel);
    returns {name: (library path, seconds)}."""
    def one(name):
        t = time.perf_counter()
        return name, (_cuda.build(name), time.perf_counter() - t)

    names = (*KERNELS, LN_KERNEL, FLOOR_KERNEL, VARIANTS_KERNEL, BATCHED_KERNEL, RELAYOUT_KERNEL,
             PVT_KERNEL, PERSISTENT_KERNEL)
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(pool.map(one, names))


# Each kernel library's ``-Xptxas -v`` report, {library: {kernel: "N regs,
# S/L spill"}}, filled once the kernels are built (``kernel_ptxas`` reads it).
PTXAS: dict = {}


def ptxas_entries(log: str) -> dict:
    """Each kernel of a ``-Xptxas -v`` log, in its order: {mangled name:
    {"registers", "smem", "stack", "spill_stores", "spill_loads",
    "wgmma_serialized"}}: whether ptxas says it serialized the kernel's
    wgmma instructions (its notes C7511 and C7512); and "setmaxnreg_ignored": True
    where it ignored the kernel's setmaxnreg (its warning C7508: no
    register count known at entry)."""
    out, name = {}, None
    serialized = set(re.findall(r"wgmma\.mma_async instructions are serialized .* (?:for|in) "
                                r"the function '(\w+)'", log))
    ignored = set(re.findall(r"setmaxnreg ignored[^\n]*?'(\w+)'", log))
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"wgmma_serialized": name in serialized}
            if name in ignored:  # (absent otherwise, so a parent's report compares)
                out[name]["setmaxnreg_ignored"] = True
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m[1]), smem=int(smem[1]) if smem else 0)
            name = None
    return out


def comparable_name(mangled: str) -> str:
    """A kernel's mangled name as a checkout without the Hopper body's
    variants gives it: variant 0's template argument (``attention_sm90.cuh``'s
    kFull) dropped, the staged form's when it is off (kStagedOut false)
    and its output argument (PlainOut), and the hashes of the file's path
    that the compiler puts
    in an anonymous namespace's name, so two checkouts' reports compare."""
    name = re.sub(r"(attention_sm90ILi\d+ELi\d+ELi\d+E)Lb0E", r"\1", mangled)
    name = re.sub(r"(attention_sm90ILi\d+ELi\d+E)Li0E", r"\1", name)
    name = name.replace("NS0_8PlainOutE", "")  # the staged form's argument, unused by the others
    # the batched kernel's option sets without the transposed scores and
    # noexp, as a checkout without those two template arguments names them
    name = re.sub(r"(attention_batchedILi\dELb[01]ELb[01]ELb[01]E)Lb0ELb0E", r"\1", name)
    return re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}", r"\1\2", name)


def kernel_label(mangled: str) -> str:
    """A short name for a kernel of the port: its body and template
    arguments ("sm90<64, 4, pipe>", "sm90<128, 4, staged>", "rope_rows<bf16, 8>",
    "stage_rows<bf16, 8, 4>", ...)."""
    k = re.search(r"(attention_bf16|attention_f32|attention_sm90)ILi(\d+)E"
                  r"(?:Li(\d+)E)?(?:Li(\d+)E)?(Lb1E)?", mangled)
    args = ", ".join(x for x in k.groups()[1:3] if x) if k else ""
    if k and k.group(4) and k.group(4) != "0":  # a stage variant (enum Variant, from 1)
        from cbas_tpu_torch.ops.attention_variants import VARIANTS

        args += f", {VARIANTS[int(k.group(4)) - 1]}"
    if k and k.group(5):  # the staged form (kStagedOut): O by plain stores
        args += ", staged"
    name = f"{k.group(1).replace('attention_', '')}<{args}>" if k else mangled
    if "ex2_bf16x2_table" in mangled:  # the stage variants' exponential table
        name = "ex2_bf16x2_table"
    b = re.search(r"attention_batchedILi(\d)ELb([01])ELb([01])ELb([01])E(?:Lb([01])ELb([01])E)?",
                  mangled)
    if b:  # the batched kernel's option set
        name = batched_label(("full", "qk", "split")[int(b.group(1))],
                             *(b.group(i) == "1" for i in range(2, 7)))
    p = re.search(r"attention_pvtILi(\d)ELb([01])E", mangled)
    if p:  # the streamed transposed-score kernel's option set (enum Form, bf16exp)
        name = pvt_label(("std", "rounded", "vext")[int(p.group(1))], p.group(2) == "1")
    if "rope_k_rows" in mangled:  # its RoPE prologue
        name = "rope_k_rows"
    f = re.search(r"attention_tf32(_wide)?ILi(\d+)ELi(\d+)E", mangled)
    if f:  # the fp32 Hopper body or its wide form: head dim, map rank
        name = f"tf32{f.group(1) or ''}<{f.group(2)}, {f.group(3)}>"
    f = re.search(r"attention_tf32_slicesILb([01])E", mangled)
    if f:  # its slices body: Q resident (d <= 576) or streamed
        name = f"tf32_slices<{'resident' if f.group(1) == '1' else 'streamed'} Q>"
    f = re.search(r"split_kvILi(\d+)E(?:Li(\d)E)?", mangled)
    if f:  # their prologue: head dim (and the columns a thread takes)
        name = f"split_kv<{f.group(1)}{', ' + f.group(2) if f.group(2) else ''}>"
    f = re.search(r"split_kv_wideILi(\d)E", mangled)
    if f:  # the slices body's prologue: the columns a thread takes
        name = f"split_kv_wide<{f.group(1)}>"
    if "relayout_kt" in mangled:
        name = "relayout_kt"
    r = re.search(r"(rope_rows|stage_rows)I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?", mangled)
    if r:  # the RoPE prologue or the staging pass: its dtype, the columns a thread
        # takes (and, staging, the columns a load reads)
        load = f", {r.group(4)}" if r.group(4) else ""
        name = f"{r.group(1)}<{'f32' if r.group(2) == 'f' else 'bf16'}, {r.group(3)}{load}>"
    n = re.search(r"(add_ln_rows|add_ln_stream)I(f|13__nv_bfloat16)(?:Li(\d+)ELi(\d+)E)?", mangled)
    if n:  # the LayerNorm: its dtype, and the elements a chunk and the chunks a thread
        dtype = "f32" if n.group(2) == "f" else "bf16"
        name = (f"ln_rows<{dtype}, V{n.group(3)}, C{n.group(4)}>" if n.group(3)
                else f"ln_stream<{dtype}>")
    s = re.search(r"attention_sm90_persistentILi(\d+)ELi(\d)ELi(\d)ELi(\d)E", mangled)
    if s:  # the persistent body: head dim, map rank, ring stages, blocks an SM
        name = f"sm90_persistent<{s.group(1)}, {s.group(2)}, {s.group(3)} stages, {s.group(4)} blocks>"
    s = re.search(r"attention_sm90_wsILi(\d+)ELi(\d)ELb([01])E", mangled)
    if s:  # the two-consumer body: head dim, map rank, the staged form
        name = f"sm90_ws<{s.group(1)}, {s.group(2)}{', staged' if s.group(3) == '1' else ''}>"
    w = re.search(r"attention_wide_bf16I(Lb[01])E", mangled)
    if w:  # the (bf16) wide body: d at run time; Q resident, or streamed above d = 1024
        name = f"wide_bf16<{'resident' if w.group(1) == 'Lb1' else 'streamed'} Q>"
    return name


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log
    (:func:`ptxas_entries`), as "<kernel label>: N regs, S/L spill" strings,
    with ", wgmma serialized" where ptxas serialized its wgmma instructions
    and ", setmaxnreg ignored" where it ignored its setmaxnreg."""
    return [f"{kernel_label(name)}: {e['registers']} regs, "
            f"{e.get('spill_stores', '?')}/{e.get('spill_loads', '?')} spill"
            + (", wgmma serialized" if e["wgmma_serialized"] else "")
            + (", setmaxnreg ignored" if e.get("setmaxnreg_ignored") else "")
            for name, e in ptxas_entries(log).items() if "registers" in e]


def kernel_ptxas(fa, kernel, dtype, d) -> str:
    """Registers and spills of the kernel ``kernel`` runs at head dim ``d``
    (K3: the width it runs at, ``headmajor_width``) in ``dtype``, from
    PTXAS (the fp32 Hopper bodies' with their prologue's; the bf16 Hopper
    body's staged form where a row is no 32-byte multiple)."""
    width = fa.headmajor_width(dtype, d) if kernel == "attention_headmajor" else d
    wide_bf16 = f"wide_bf16<{'resident' if d <= 1024 else 'streamed'} Q>"
    body = fa.attention_body(kernel, dtype, width)
    tf32 = body in fa.TF32_BODIES
    slices = f"tf32_slices<{'resident' if d <= 576 else 'streamed'} Q>"
    prefix = {"sm90": f"sm90<{width}, ", "sm90_ws": f"sm90_ws<{width}, ", "wide": wide_bf16,
              "sm90_f32": f"tf32<{width}, ",
              "sm90_f32_wide": f"tf32_wide<{width}, ", "sm90_f32_slices": slices}[body]
    prologue = r"split_kv_wide<" if body == "sm90_f32_slices" else rf"split_kv<{width}[,>]"
    staged = body in fa.BF16_BODIES and fa.headmajor_staged(dtype, d)
    found = [f"{k}: {v}" if tf32 else v
             for k, v in PTXAS.get(kernel, {}).items()
             if k.startswith(prefix) and k.endswith(", staged>") == staged]
    if tf32:
        found = ["; ".join(found + [f"{k}: {v}" for k, v in PTXAS.get(kernel, {}).items()
                                    if re.match(prologue, k)])]
    return found[0] if found and found[0] else "not in the build log"


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


def head_tables(torch, cfg, head_dim, grid, n_tokens, device="cuda"):
    """RoPE tables for a case at ``head_dim``: the model's (:func:`rope_full`)
    where its rule builds them (a multiple of 4), else tables of random
    angles from a seed, one angle a column (rotate-half at any width)."""
    if head_dim % 4 == 0:
        return rope_full(torch, cfg, head_dim, grid, n_tokens, device)
    ang = np.random.default_rng(SEED + 11).uniform(-np.pi, np.pi, (n_tokens, head_dim))
    return tuple(torch.from_numpy(f(ang.astype(np.float32))).to(device) for f in (np.cos, np.sin))


# The memory floor's time at each (elements a tensor, dtype) the floor phase
# or a timed case measured: {(n, dtype name): ms}.
FLOOR_MS: dict = {}


def floor_inputs(torch, shape, dtype, device="cuda"):
    """q, k and v of ``shape`` from a numpy seed, with the values that tell
    the expression from a copy at their first elements: +-Inf and NaN in k
    and v (6 NaNs in o: Inf * 0 is NaN), and -0 in q beside k and v of
    either sign (one -0 left in o: -0 + -0 + -0)."""
    rng = np.random.default_rng(SEED + 14)
    n = int(np.prod(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(n, np.float32)).to(device, getattr(torch, dtype))
               for _ in range(3))
    special = torch.tensor([float("inf"), float("-inf"), float("nan"), 1.0, -1.0, 1.0, -1.0, 2.0])
    k[:8] = special.to(device, k.dtype)
    v[8:16] = special.to(device, v.dtype)
    q[16:20] = torch.tensor([-0.0, -0.0, -0.0, 0.0]).to(device, q.dtype)
    k[16:20] = torch.tensor([1.0, -1.0, -1.0, -1.0]).to(device, k.dtype)
    v[16:20] = torch.tensor([-1.0, 1.0, -1.0, -1.0]).to(device, v.dtype)
    return tuple(t.view(shape) for t in (q, k, v))


def floor_ms(torch, n, dtype) -> float:
    """The memory floor's ms at four tensors of ``n`` elements of ``dtype``
    (a name), measured once and kept in FLOOR_MS."""
    from cbas_tpu_torch.ops import memory_floor as mf

    key = (n, dtype)
    if key not in FLOOR_MS:
        q, k, v = floor_inputs(torch, (n,), dtype)
        FLOOR_MS[key] = time_ms(torch, lambda: mf.memory_floor(q, k, v))
    return FLOOR_MS[key]


def floor_case(torch, mf, label, shape, dtype, device="cuda") -> dict:
    """The memory floor on the card against its plain version, bit for bit
    (NaN where the plain version has NaN; whether the NaN bits match too is
    reported), then timed beside the plain version, ``out.copy_(q)`` (the
    card's copy rate over half the bytes, named as such: no PyTorch call
    computes the expression) and its bound at the peak memory rate.
    (``device`` is "cpu" only in the CPU test of this function: the plain
    version on both sides, untimed.)"""
    q, k, v = floor_inputs(torch, shape, dtype, device)
    before = mf.launches
    got = mf.memory_floor(q, k, v)
    want = mf.memory_floor_reference(q, k, v)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    ints = torch.int16 if dtype == "bfloat16" else torch.int32
    same_bits = got.view(ints) == want.view(ints)
    nan = torch.isnan(want)
    numbers_equal = bool((same_bits | (nan & torch.isnan(got))).all())
    n = q.numel()
    nbytes = 4 * n * q.element_size()
    out = {"phase": "memory_floor", "what": label, "shape": list(shape), "dtype": dtype,
           "mbytes": nbytes / 1e6, "launches": mf.launches - before,
           "bit_equal_where_not_nan": numbers_equal, "nan_bits_equal": bool(same_bits.all()),
           "nan_count": int(nan.sum()),
           "max_abs_err": float((got.float() - want.float())[~nan].abs().max()),
           "minus_zero_in_q_kept": int(torch.signbit(got.flatten()[16:20]).sum())}
    out["ok"] = numbers_equal and got.shape == q.shape and got.is_contiguous() \
        and out["launches"] == int(on_card) and out["nan_count"] == 6 \
        and out["minus_zero_in_q_kept"] == 1  # a copy of q would keep 3 (floor_inputs)
    if on_card:
        FLOOR_MS[(n, dtype)] = out["ms"] = time_ms(torch, lambda: mf.memory_floor(q, k, v))
        out["plain_ms"] = time_ms(torch, lambda: mf.memory_floor_reference(q, k, v))
        copy = torch.empty_like(q)
        out["copy_ms"] = time_ms(torch, lambda: copy.copy_(q))
        out["gbps"] = nbytes / out["ms"] / 1e6
        out["copy_gbps"] = 2 * n * q.element_size() / out["copy_ms"] / 1e6
        out["bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
        out["bound_by"] = "bytes"
        out["share_of_peak"] = out["bound_ms"] / out["ms"]
        out["library_ms"] = None
    return out


def floor_phase(torch, device="cuda") -> dict:
    """The memory floor at every row of :func:`floor_rows`, its launch count
    set to 0 before and read after: {"cases": [...], "launches": N}.
    (``device`` is "cpu" only in the CPU test, where ``rows`` are cut.)"""
    from cbas_tpu_torch.ops import memory_floor as mf

    mf.launches = 0
    cases = []
    for label, shape, dtype in floor_rows():
        cases.append(floor_case(torch, mf, label, shape, dtype, device))
        emit(cases[-1])
    launches = mf.launches
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"the memory floor disagrees with its plain version: {bad}")
    if device == "cuda" and launches < len(cases):
        raise AssertionError(f"the floor phase launched the kernel {launches} times")
    chain = floor_chain(torch, device) if device == "cuda" else None
    return {"cases": cases, "launches": launches, "chain": chain}


# probe15's chained floor (probe15_marginal_256.py:50-81): each function applied
# K times in one program with each application's input the last one's output
# (x = f(x, k, v)), so the marginal cost (tK - t1) / (K - 1) of an application
# leaves out what a call costs to issue. Here one program is a CUDA graph of
# the chain, replayed and timed by CUDA events. The functions: the memory
# floor ("dma"), K2 with RoPE ("prod"), the plain torch sum q + k 1e-3 + v
# 1e-3 in bf16 ("xlaadd", the probe's non-Pallas baseline) and K2's library
# yardstick, SDPA without RoPE ("sdpa", FLOOR_CHAIN_LIBRARY), at probe15's
# (384, 6, 272, 128) bf16 blocks, 261 live keys for K2, standard normal x 0.3
# inputs and standard normal (N, 64) tables; its bytes total_bytes = 4 BG N
# 128 2 (q, k, v read, o written).
FLOOR_CHAIN_SHAPE = (384, 6, 272, 128)
FLOOR_CHAIN_NV, FLOOR_CHAIN_K = 261, 5
FLOOR_CHAIN_SITE = "benchmarks/attn_probes/probe15_marginal_256.py:50"


# The chain's library yardstick (its graphs timed like the port's, its
# eager-equal check recorded but not required: not the port's code).
FLOOR_CHAIN_LIBRARY = "sdpa"


def floor_chain_fns(torch, inputs) -> dict:
    """probe15's three functions x -> f(x, k, v) over ``inputs`` ((B, G, N,
    128) q, k, v and (N, 64) cos, sin), and FLOOR_CHAIN_LIBRARY: K2's
    attention without its RoPE by ``scaled_dot_product_attention`` (keys
    past FLOOR_CHAIN_NV masked), the one PyTorch call that prices
    ``prod``: K and V as head-major (B G, 2, N, 64) copies made here, x's
    bytes read as head-major queries and its output's as the next x, so
    the chain copies nothing."""
    from cbas_tpu_torch.ops import flash_attention as fa
    from cbas_tpu_torch.ops import memory_floor as mf

    q, k, v, cos, sin = inputs
    B, G, N, dd = q.shape
    scale = (dd // 2) ** -0.5
    milli = torch.tensor(1e-3, dtype=q.dtype, device=q.device)
    live = (torch.arange(N, device=q.device) < FLOOR_CHAIN_NV)[None, None, None, :]
    kh, vh = (t.view(B * G, N, 2, dd // 2).transpose(1, 2).contiguous() for t in (k, v))

    def sdpa(x):
        o = torch.nn.functional.scaled_dot_product_attention(
            x.view(B * G, 2, N, dd // 2), kh, vh, attn_mask=live, scale=scale)
        return o.view(B, G, N, dd)

    def dma(x):
        return mf.memory_floor(x.view(B * G, N, dd), k.view(B * G, N, dd),
                               v.view(B * G, N, dd)).view(B, G, N, dd)

    def prod(x):
        return fa.fused_attention_packed(x, k, v, scale, FLOOR_CHAIN_NV, cos, sin)

    def xlaadd(x):
        return x + k * milli + v * milli

    return {"dma": dma, "prod": prod, "xlaadd": xlaadd, FLOOR_CHAIN_LIBRARY: sdpa}


def chain(fn, x, times: int):
    """``fn`` applied ``times`` times, each to the last one's output."""
    for _ in range(times):
        x = fn(x)
    return x


def floor_chain_inputs(torch, device="cuda") -> tuple:
    """probe15's q, k, v at FLOOR_CHAIN_SHAPE and its tables, from a seed."""
    gen = torch.Generator(device).manual_seed(SEED + 15)
    B, G, N, dd = FLOOR_CHAIN_SHAPE
    q, k, v = ((torch.randn(B, G, N, dd, generator=gen, device=device) * BATCHED_INPUT_SCALE)
               .to(torch.bfloat16) for _ in range(3))
    cos, sin = (torch.randn(N, dd // 2, generator=gen, device=device) for _ in range(2))
    return q, k, v, cos, sin


def floor_chain(torch, device="cuda") -> dict:
    """probe15's chain for each function: the K-fold chain against K eager
    calls (bit for bit), then on the card CUDA graphs of one and of K
    applications, each replay timed, the marginal (tK - t1) / (K - 1), its
    GB/s over probe15's total_bytes, and one eager call's time beside it.
    Raises where a graph's result leaves the eager chain's. (``device`` is
    "cpu" only in the CPU test: no graphs, the shape cut.)"""
    inputs = floor_chain_inputs(torch, device)
    q = inputs[0]
    total_bytes = 4 * q.numel() * q.element_size()
    K, on_card = FLOOR_CHAIN_K, device == "cuda"
    out = {"phase": "floor_chain", "what": "probe15 chained floor", "site": FLOOR_CHAIN_SITE,
           "shape": list(q.shape), "n_valid": FLOOR_CHAIN_NV, "K": K,
           "total_mbytes": total_bytes / 1e6, "fns": {}}
    for name, fn in floor_chain_fns(torch, inputs).items():
        eager = [q]
        for _ in range(K):
            eager.append(fn(eager[-1]))
        entry = {"changes_x": not torch.equal(eager[1], q)}
        if on_card:
            graphs, results = {}, {}
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up off the capture, as graphs ask
                chain(fn, q, K)
            torch.cuda.current_stream().wait_stream(side)
            for times in (1, K):
                graphs[times] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[times]):
                    results[times] = chain(fn, q, times)
            for times in (1, K):
                graphs[times].replay()
            torch.cuda.synchronize()
            entry["graph_equals_eager"] = all(
                torch.equal(results[t].view(torch.int16), eager[t].view(torch.int16))
                for t in (1, K))
            t1, tk = (time_ms(torch, graphs[t].replay) for t in (1, K))
            marginal = (tk - t1) / (K - 1)
            entry.update({"t1_ms": t1, f"t{K}_ms": tk, "marginal_ms": marginal,
                          "gbps": total_bytes / marginal / 1e6,
                          "eager_ms": time_ms(torch, lambda: fn(q)),
                          "launch_overhead_ms": t1 - marginal})
            del graphs, results
        else:
            entry["graph_equals_eager"] = torch.equal(chain(fn, q, K), eager[K])
        entry["ok"] = entry["graph_equals_eager"] or name == FLOOR_CHAIN_LIBRARY
        out["fns"][name] = entry
    emit(out)
    bad = {name: e for name, e in out["fns"].items() if not e["ok"]}
    if bad:
        raise AssertionError(f"a chained floor's graph leaves its eager chain: {bad}")
    return out


def entry_and_body_launches(fa) -> dict:
    """The launch counts of each entry, of each body and of bf16's staging
    pass ("staging"), by name."""
    return {"attention_fat": fa.launches, "attention_packed": fa.launches_packed,
            "attention_headmajor": fa.launches_headmajor, "sm90": fa.launches_sm90,
            "sm90_f32": fa.launches_sm90_f32, "sm90_f32_wide": fa.launches_sm90_f32_wide,
            "sm90_f32_slices": fa.launches_sm90_f32_slices, "wide": fa.launches_wide,
            "sm90_ws": fa.launches_sm90_ws, "staging": fa.launches_stage}


def kernel_case(torch, fa, cfg, kernel, B, H, N, d, grid, dtype, rope, n_valid=None,
                time_it=True, view=False, tables=None):
    """One fused-attention case on the card against its plain version, in
    the kernel's own layout; with ``view`` True (K2 and K3), on head-pair or
    head-major views of flat (B, N, H*d) tensors, and with ``view`` "fused"
    on the q, k and v column blocks of one fused (B, N, 3*H*d) projection
    (and their head-pair or head-major views), as the model's routes pass
    them; then the output is dense in q's dim order and the kernel agrees
    bit for bit with itself on contiguous copies of the views. ``tables``, a
    (cos, sin) pair on the card, replaces the model's RoPE tables."""
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
    if view == "fused":
        qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to("cuda", dtype)
        q, k, v = (qkv[..., j * H * d:(j + 1) * H * d] for j in range(3))
    else:
        q, k, v = (
            torch.from_numpy(rng.standard_normal((B, N, H * d) if view else shape, np.float32))
            .to("cuda", dtype) for _ in range(3)
        )
    if view and kernel != "attention_fat":
        group = 2 if kernel == "attention_packed" else 1
        q, k, v = (t.view(B, N, H // group, group * d).transpose(1, 2) for t in (q, k, v))
    if n_valid is not None:  # dead rows hold NaN: the masks must keep it out
        dead = (slice(None),) * token_dim + (slice(n_valid, None),)
        k[dead] = float("nan")
        v[dead] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = tables or head_tables(torch, cfg, d, grid, N)
    scale = d ** -0.5
    body = fa.attention_body(
        kernel, dtype, fa.headmajor_width(dtype, d) if kernel == "attention_headmajor" else d)
    before = entry_and_body_launches(fa)
    got = wrapper(q, k, v, scale, n_valid, cos, sin)
    launched = {key: n - before[key] for key, n in entry_and_body_launches(fa).items()}
    want_launched = {key: int(key in (kernel, body)) for key in launched}
    want_launched["staging"] = int(kernel == "attention_headmajor"
                                 and fa.headmajor_staged(dtype, d, rope))
    want = plain(q, k, v, scale, n_valid, cos, sin)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        tol = KERNEL_FP32_TOL * (1 + want.float().abs())
        tol_text = f"{KERNEL_FP32_TOL} abs + rel"
    else:
        live = (slice(None),) * token_dim + (slice(0, n_valid or N),)
        vmax = float(v[live].float().abs().max())
        tol = dtype_ulp(torch, want.float()) + KERNEL_BF16_VREL * vmax + KERNEL_BF16_FLOOR
        tol_text = f"1 bf16 ulp + 2^-8 max|v| ({KERNEL_BF16_VREL * vmax:.3g}) + {KERNEL_BF16_FLOOR}"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all()) and launched == want_launched
    copies = [t.contiguous() for t in (q, k, v)]
    # K3 copies and pads the heads it reads at no width of its own (fp32 off
    # the multiples of 4, bf16 off those of 8): its output is then contiguous.
    padded = kernel == "attention_headmajor" and not fa.headmajor_in_place(dtype, d, rope)
    if view:  # a dense output in q's dim order, the same bits as on contiguous copies
        ok = ok and bool(torch.equal(got, wrapper(*copies, scale, n_valid, cos, sin)))
        ok = ok and (got.is_contiguous() if padded else got.stride() == fa._dense_like(q).stride())
        if kernel != "attention_fat" and not padded:  # the context back to (B, N, H*d): a view
            flat = got.transpose(1, 2).reshape(B, N, H * d)
            ok = ok and flat.data_ptr() == got.data_ptr() and flat.is_contiguous()
    out = {
        "phase": "kernel", "name": kernel, "body": body, "launches": launched,
        "inputs": ("views of one fused (B, N, 3*H*d) projection" if view == "fused"
                   else "views of flat tensors" if view else "contiguous"),
        "B": B, "N": N, "H": H, "head_dim": d,
        "dtype": str(dtype).replace("torch.", ""), "rope": rope, "n_valid": n_valid,
        "max_abs_err": float(err.max()), "tol": tol_text, "ok": ok,
        "ptxas": kernel_ptxas(fa, kernel, dtype, d),
    }
    if time_it:
        out["ms"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid, cos, sin))
        out["plain_ms"] = time_ms(torch, lambda: plain(q, k, v, scale, n_valid, cos, sin))
        out["ms_norope"] = time_ms(torch, lambda: wrapper(q, k, v, scale, n_valid))
        if view == "fused":  # the same call on contiguous tensors, in the same run
            out["contiguous_ms"] = time_ms(torch, lambda: wrapper(*copies, scale, n_valid, cos, sin))
            out["contiguous_ms_norope"] = time_ms(torch, lambda: wrapper(*copies, scale, n_valid))
        out.update(attention_bound(B, N, H, d, n_valid or N, rope, dtype == torch.float32))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        out["floor_ms"] = floor_ms(torch, B * N * H * d, str(dtype).replace("torch.", ""))
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
    tensor cores; fp32 at the 3xTF32 rate, PEAK_F32_ACCURATE_FLOPS), against
    q and o (N rows), k and v (n_valid rows) and the fp32 RoPE tables moved
    once."""
    flop = 4 * B * H * N * n_valid * d
    nbytes = (4 if fp32 else 2) * B * H * d * (2 * N + 2 * n_valid) + (2 * N * d * 4 if rope else 0)
    t_ops = flop / (PEAK_F32_ACCURATE_FLOPS if fp32 else PEAK_BF16_FLOPS)
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
    return ms, sorted(set(trace_kernels(torch, lambda: sdpa(q, k, v, scale=scale))))


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
    under "<name>_contiguous" K2's and K3's on contiguous tensors, under
    "<name>_fused" each kernel's on views of one fused projection at
    FUSED_SHAPES), the fp32 cases under "fp32", and under "padded_calls"
    the kernels one K3 call launches at phase 10's padded widths
    (:func:`padded_calls`)."""
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
    # Small widths: bf16 on the Hopper body at 64 (8 and 24 staged, 16 and
    # 32 on maps at d) and fp32 on its fp32 counterpart, the tensor maps at
    # d (a 32-column atom wholly beyond d at 8 to 32, RoPE pairing at d/2);
    # then 13 with tables of
    # random angles (the model's need d % 4 == 0): in bf16 through the
    # staging launch at 64, in fp32 no multiple of 4, so copied and padded
    # to 16 first (and roped before the copy).
    for d in (8, 16, 24, 32):
        sweep("attention_headmajor", 4, d, small=((2, 261, g256),), dead=((4, 272, 261, g256),))
    for B, N, n_valid in ((2, 261, None), (4, 272, 261)):
        ang = np.random.default_rng(SEED + 13).uniform(-np.pi, np.pi, (N, 13)).astype(np.float32)
        tables = tuple(torch.from_numpy(f(ang)).to("cuda") for f in (np.cos, np.sin))
        for dtype in (bf16, f32):
            for rope in (False, True):
                results.append(kernel_case(torch, fa, cfg, "attention_headmajor", B, 4, N, 13, g256,
                                           dtype, rope, n_valid=n_valid, tables=tables))
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
    # fp32 Hopper body: K1, K2 (views) and K3 (views) at d 64, and K3 (views)
    # at the ViT-7B width.
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
    # Views of one fused (B, N, 3*H*d) projection, the routes' operands
    # since the projection is one GEMM: small cases of every body (bf16 and
    # fp32, RoPE on and off, NaN in the dead rows), untimed; then the main
    # shapes in bf16 with RoPE, timed beside contiguous copies and SDPA.
    sweep("attention_fat", H, 64, views=("fused",), small=((2, 261, g256), (1, 1205, g480)),
          dead=((2, 272, 261, g256),), time_it=False)
    sweep("attention_packed", H, 64, views=("fused",), small=((2, 261, g256),),
          dead=((2, 272, 261, g256),), time_it=False)
    for d in (40, 64, 128, 160, 192, 256, 320):
        sweep("attention_headmajor", 4, d, views=("fused",), small=((2, 261, g256),),
              dead=((2, 329, 300, g288),), time_it=False)
    for kernel, shapes in (("attention_fat", FUSED_SHAPES), ("attention_packed", FUSED_SHAPES),
                           ("attention_headmajor", FUSED_SHAPES + FUSED_SHAPES_7B)):
        main[f"{kernel}_fused"] = [
            kernel_case(torch, fa, cfg, kernel, B, H_, N, d, g256 if N == 261 else g480, bf16,
                        True, view="fused") for B, N, H_, d in shapes]
        results += main[f"{kernel}_fused"]
    main["padded_calls"] = padded_calls(torch, fa, cfg)
    for r in results:
        emit(r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused attention disagrees with its plain version: {bad}")
    return main


# The fp32 Hopper body (csrc/attention_sm90_tf32.cuh; fp32 at head dims 64
# and 128 in K1, K2 and K3). Its prologue (split_kv: K roped and split, V
# transposed into the body's key order and split, once a call) alone at the
# fp32 main paths' shapes, (B, N, H, d, n_valid): K1's and K3's, on
# head-major views of one fused projection with the model's tables, then
# 272 / 261 with NaN in the dead rows; bit for bit against its plain version,
# RoPE on and off, timed beside its byte bound and the floor.
TF32_PROLOGUE_CASES = ((BATCH_256, 261, 12, 64, None), (BATCH_480, 1205, 12, 64, None),
                       (BATCH_7B_256, 261, 32, 128, None), (BATCH_7B_480, 1205, 32, 128, None),
                       (4, 272, 12, 64, 261), (2, 272, 32, 128, 261))


def tf32_prologue_case(torch, fa, cfg, B, N, H, d, n_valid, rope) -> dict:
    """The prologue on the card against its plain version, bit for bit
    (NaN in the dead rows must not reach its planes), timed beside its byte
    bound (k and v read over the live rows, the tables, the four planes
    written) and the memory floor at those bytes."""
    rng = np.random.default_rng(SEED + 17)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to("cuda")
    k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2) for j in (1, 2))
    nv = n_valid or N
    if n_valid is not None:
        k[:, :, nv:] = float("nan")
        v[:, :, nv:] = float("nan")
    cos, sin = rope_full(torch, cfg, d, (16, 16) if N < 1000 else (30, 40), N, "cuda") \
        if rope else (None, None)
    got = fa.tf32_prologue(k, v, n_valid, cos, sin)
    want = fa.tf32_prologue_reference(k, v, n_valid, cos, sin)
    torch.cuda.synchronize()
    out = {"phase": "tf32_prologue", "shape": [B, N, H, d], "n_valid": n_valid, "rope": rope,
           "inputs": "head-major views of one fused (B, N, 3*H*d) projection",
           "bit_equal": bool(torch.equal(got, want)),
           "max_abs_diff": float((got - want).abs().max()),
           "planes": list(got.shape)}
    out["ok"] = out["bit_equal"]
    if n_valid is None:
        out["ms"] = time_ms(torch, lambda: fa.tf32_prologue(k, v, n_valid, cos, sin))
        out["plain_ms"] = time_ms(torch, lambda: fa.tf32_prologue_reference(k, v, n_valid, cos, sin),
                                  iters=3, warmup=1)
        nbytes = 4 * (2 * B * H * nv * d + got.numel()) + (2 * nv * d * 4 if rope else 0)
        out.update({"mbytes": nbytes / 1e6, "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                    "bound_by": "bytes", "gbps": nbytes / out["ms"] / 1e6,
                    "floor_ms": floor_ms(torch, nbytes // 16, "float32")})
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def tf32_phase(torch, fa, cfg) -> dict:
    """TF32_PROLOGUE_CASES (RoPE on and off), the prologue's launch count
    set to 0 before and read after: {"prologue": cases, "launches"}. A case
    that disagrees raises."""
    fa.launches_tf32_prologue = 0
    prologue = [tf32_prologue_case(torch, fa, cfg, *case, rope)
                for case in TF32_PROLOGUE_CASES for rope in (True, False)]
    out = {"prologue": prologue, "launches": {"tf32_prologue": fa.launches_tf32_prologue}}
    for line in prologue:
        emit(line)
    emit({"phase": "tf32_summary", "launches": out["launches"]})
    bad = [c for c in prologue if not c["ok"]]
    if bad or not fa.launches_tf32_prologue:
        raise AssertionError(f"the fp32 body's prologue disagrees: {bad}, "
                             f"launches {out['launches']}")
    return out


# What gpu_clocks samples: the SM clock and power draw, then the temperature
# and the bit mask of reasons the clock is held down (0x1 idle, 0x4 power
# cap, 0x20 / 0x40 thermal, 0x8 / 0x80 hardware slowdown).
GPU_CLOCK_FIELDS = "clocks.sm,power.draw,temperature.gpu,clocks_event_reasons.active"


def gpu_clocks() -> str:
    """The card's GPU_CLOCK_FIELDS now, as ``nvidia-smi`` reads them; raises
    if it refuses the query."""
    proc = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_CLOCK_FIELDS}",
                           "--format=csv,noheader"], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvidia-smi refuses --query-gpu={GPU_CLOCK_FIELDS}: "
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def stage_inputs(torch, cfg, case, device="cuda"):
    """q, k, v and the tables of a STAGE_CASES case, drawn on ``device``
    from a seeded generator (the probes' shape is 0.9 G values, slow to draw
    on the host): the probes' packed blocks (standard normal x 0.3, standard
    normal tables, as probe2.py and probe4.py make them) where the case has
    no patch grid, else the column blocks of one fused (B, N, 3*H*d)
    projection (and their head-major views) with the model's tables, as
    kernel_case makes them. NaN in the rows of k and v at or past n_valid."""
    _, layout, B, N, H, d, n_valid, grid = case
    gen = torch.Generator(device).manual_seed(SEED + 2)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if grid is None:
        q, k, v = ((normal(B, H // 2, N, 2 * d) * STAGE_PROBE_INPUT_SCALE).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = normal(N, d), normal(N, d)
    else:
        qkv = normal(B, N, 3 * H * d).to(torch.bfloat16)
        q, k, v = (qkv[..., j * H * d:(j + 1) * H * d] for j in range(3))
        if layout == "headmajor":
            q, k, v = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
        cos, sin = rope_full(torch, cfg, d, grid, N, device)
    token_dim = 1 if layout == "fat" else 2
    dead = (slice(None),) * token_dim + (slice(n_valid, None),)
    k[dead] = float("nan")
    v[dead] = float("nan")
    return q, k, v, cos, sin


def stage_tolerance(torch, av, variant, layout, q, k, v, scale, nv, cos, sin, want,
                    ex2_dev=None):
    """The bound on |kernel - plain| of ``variant`` at each output element,
    in ``layout`` (its reasons beside each case below). Both sides read the
    same bf16 roped q and k (RoPE in fp32, one rounding). ``ex2_dev``: the
    card's ex2.approx.ftz.bf16x2 against the correctly rounded 2^y
    (:func:`ex2_deviation`); None where the kernel's are taken as correctly
    rounded (the CPU tests)."""
    ulp = functools.partial(dtype_ulp, torch)
    qh, kh, vh, s = av.roped_scores(*(av.to_heads(t, layout) for t in (q, k, v)), scale, nv,
                                    cos, sin, torch.bfloat16)
    want = av.to_heads(want.float(), layout).abs()
    d = qh.shape[-1]
    # The scores: each side sums d exact bf16 products in fp32 in its own
    # order (the tensor cores' and the plain matmul's), at most 2 ulps of
    # the running |sum| an add (a truncating accumulator), so they differ by
    # at most d 2^-22 sum_i |q_i k_i|.
    ds = d * 2.0 ** -22 * (qh.abs() @ kh.abs().transpose(-1, -2))
    if variant == "qk":  # scores of keys 0..d-1, each rounded once to bf16 on each side
        ds = torch.nn.functional.pad(ds[..., :d], (0, max(0, d - ds.shape[-1])))
        return av.from_heads(ds + ulp(want + ds), layout)
    if variant == "nosm":
        # p = bf16(s) on each side may round the two scores one ulp apart;
        # then p.V over nv keys in fp32 in two orders; then the output's
        # rounding.
        dp = ds + ulp(s.abs() + ds)
        dv = dp @ vh.abs() + nv * 2.0 ** -22 * (s.to(torch.bfloat16).float().abs() @ vh.abs())
        return av.from_heads(dv + ulp(want + dv), layout)
    # vext, vext_bf16exp: the plain version runs the kernel's own loop
    # (av.online_softmax: the same tiles, running max and rounding points),
    # so the two differ only by the scores' ds and by what ds can move:
    # - the running max m of a row, by at most s_m = max over its keys of ds;
    # - x = s log2(e) - m log2(e), by at most dx = log2(e) (ds + s_m) and
    #   the fp32 roundings of x and of m log2(e);
    # - p: where every value within dx of x rounds to the same bf16 x
    #   (bf16exp) or every value within 2^x (1 +- ln(2) dx + 2^-20) to the
    #   same bf16 p (vext; 2^-20 covers both sides' fp32 exponentials), the
    #   two p are equal; else p lies in [p_lo, p_hi], the rounded ends. On
    #   the card ex2.approx.ftz.bf16x2 may leave the correctly rounded 2^y:
    #   its own results (``ex2_dev``, |ln(card / plain)| by the input's bit
    #   pattern) widen p_lo and p_hi;
    # - the product of the later tiles' alphas, by a factor within e^(+-b),
    #   b = 2 s_m (both maxima; ln(2) log2(e) = 1) + 2^-20 a tile.
    # So each key's weight (p a, a = av.online_softmax's factor) moves by at
    # most D_j = a (max(p_hi - p, p - p_lo) + p_hi expm1(b)), and the
    # weighted mean o by at most (sum D_j |v_j| + |o| sum D_j) / (1 - sum
    # D_j). Each side sums p.V in fp32 tile by tile into the carried
    # accumulator: at most KEY_TILE + 1 roundings of 2^-22 of a running sum
    # no larger than the carried one plus the tile's sum w_j |v_j| (w = p a;
    # the kernel's w within D_j of it), in units of the final lsum; p.1 adds
    # nv 2^-22 |o| a side (all its terms are positive), the inverse and
    # product 2^-21 |o|; then the output's rounding.
    bf16exp = variant == "vext_bf16exp"
    live = torch.arange(s.shape[-1], device=s.device) < nv
    ds = torch.where(live, ds, 0.0)
    s_m = ds.amax(-1, keepdim=True)
    o, x, p, a = av.online_softmax(s, vh, nv, bf16exp=bf16exp)
    dx = av.LOG2E * (ds + s_m) + 2.0 ** -21 * (x.abs() + av.LOG2E * s.abs().amax(-1, keepdim=True))
    x, dx = torch.where(live, x, 0.0), torch.where(live, dx, 0.0)
    if bf16exp:
        lo, hi = ((x + sign * dx).to(torch.bfloat16) for sign in (-1, 1))
        p_lo, p_hi = av.ex2_bf16(lo), av.ex2_bf16(hi)
        if ex2_dev is not None:
            p_lo = p_lo * torch.exp(-ex2_dev[av.bf16_bits(lo)])
            p_hi = p_hi * torch.exp(ex2_dev[av.bf16_bits(hi)])
    else:
        e, eps = torch.exp2(x), math.log(2.0) * dx + 2.0 ** -20
        p_lo, p_hi = ((e * (1 + sign * eps)).to(torch.bfloat16).float() for sign in (-1, 1))
    b = 2 * s_m + 2.0 ** -20 * -(-nv // av.KEY_TILE)
    dw = a * (torch.maximum(p_hi - p, p - p_lo) + p_hi * torch.expm1(b))
    dw = torch.where(live, dw, 0.0)
    dw_sum = dw.sum(-1, keepdim=True)
    w, carried, prefix = p * a, torch.zeros_like(o), torch.zeros_like(o)
    for k0 in range(0, nv, av.KEY_TILE):
        carried += prefix.abs()
        prefix += w[..., k0:k0 + av.KEY_TILE] @ vh[..., k0:k0 + av.KEY_TILE, :]
    sums = (av.KEY_TILE + 1) * 2.0 ** -21 * (carried + (w + (1 + nv // av.KEY_TILE) * dw)
                                              @ vh.abs())
    dv = (dw @ vh.abs() + dw_sum * o.abs()) / (1 - dw_sum) + sums + (nv + 1) * 2.0 ** -21 * o.abs()
    return av.from_heads(dv + ulp(torch.maximum(want, o.abs()) + dv), layout)


# The sanity bound held on the card's ex2.approx.ftz.bf16x2 for every bf16
# input whose 2^y is a normal bf16: relative error at most 2^-7.
EX2_BF16_REL = 2.0 ** -7


def ex2_deviation(torch, av) -> tuple:
    """The card's ex2.approx.ftz.bf16x2 (``vext_bf16exp``'s exponential) at
    every bf16 input against the correctly rounded 2^y (``av.ex2_bf16``):
    (|ln(card / plain)| by bit pattern, both clamped below at 2^-126, 0
    where they agree and above y = 1, which no argument x <= 0 reaches; a
    report). Raises where the instruction
    leaves 2^y by more than EX2_BF16_REL, relatively, at an input whose 2^y
    is a normal bf16."""
    y = av.bf16_values("cuda")
    card, plain = av.ex2_bf16_on_card("cuda"), av.ex2_bf16(y)
    exact = torch.exp2(y.double())
    normal = torch.isfinite(y) & (exact >= 2.0 ** -126) & (exact < 2.0 ** 128)
    rel = torch.where(normal, (card.double() - exact).abs() / exact, 0.0)
    differ = torch.isfinite(y) & (card != plain)
    dev = (card.clamp_min(2.0 ** -126).log() - plain.clamp_min(2.0 ** -126).log()).abs()
    dev = torch.where(torch.isfinite(y) & (y <= 1) & (card != plain), dev, 0.0)
    report = {"inputs": int(torch.isfinite(y).sum()), "differ_from_correctly_rounded":
              int(differ.sum()), "max_rel_err": float(rel.max()), "max_ln_dev": float(dev.max()),
              "bound_rel": EX2_BF16_REL}
    if not bool(torch.isfinite(dev).all()) or report["max_rel_err"] > EX2_BF16_REL:
        raise AssertionError(f"ex2.approx.ftz.bf16x2 leaves 2^y: {report}")
    return dev, report


def stage_check(torch, av, variant, layout, q, k, v, scale, nv, cos, sin, got, full,
                ex2_dev=None) -> dict:
    """``got``, the variant's output, against its yardstick: "dma" against
    its plain version (q) bit for bit, "pipe" against variant 0's output
    ``full`` bit for bit, the rest against their plain versions within
    :func:`stage_tolerance` (``ex2_dev`` passed on), the batch taken in
    chunks whose scores fit in 2 GiB of fp32."""
    B, N, H, d = av._shape(q, layout)
    n_valid = nv if nv < N else None
    if variant in ("dma", "pipe"):
        want = q if variant == "dma" else full
        ok = bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
        err = float((got.float() - want.float()).abs().max())
        return {"max_abs_err": err, "tol": "bit-equal to " + ("q" if variant == "dma" else
                                                              "variant 0"), "ok": ok}
    chunk = max(1, 2 ** 31 // (4 * H * N * N))
    err, worst, ok = 0.0, 0.0, bool(torch.isfinite(got).all())
    for b0 in range(0, B, chunk):
        part = [t[b0:b0 + chunk] for t in (q, k, v)]
        want = av.attention_variant_reference(*part, scale, n_valid, cos, sin, variant=variant,
                                              layout=layout)
        tol = stage_tolerance(torch, av, variant, layout, *part, scale, nv, cos, sin, want,
                              ex2_dev)
        e = (got[b0:b0 + chunk].float() - want.float()).abs()
        err = max(err, float(e.max()))
        worst = max(worst, float((e / tol).max()))
        ok = ok and bool((e <= tol).all())
    return {"max_abs_err": err, "max_err_over_tol": worst,
            "tol": "stage_tolerance (chip_smoke.py)", "ok": ok}


def stage_bound(variant, B, N, H, d, n_valid, rope) -> dict:
    """The least time for a variant's claimed work: "dma" the bytes of q, k,
    v and o its ring and store move; "qk" those, the tables and q.k^T over
    the live keys; the rest the attention's own bound (attention_bound)."""
    if variant not in ("dma", "qk"):
        return attention_bound(B, N, H, d, n_valid, rope)
    flop = 2 * B * H * N * n_valid * d if variant == "qk" else 0
    nbytes = 2 * B * H * d * (2 * N + 2 * n_valid) + (
        2 * N * d * 4 if rope and variant == "qk" else 0)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"gflop": flop / 1e9, "mbytes": nbytes / 1e6, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def stage_case(torch, fa, av, case, inputs, rope, device="cuda", plain=False,
               ex2_dev=None) -> dict:
    """One STAGE_CASES case on its ``inputs`` (:func:`stage_inputs`), with
    RoPE or without: every variant against its
    yardstick (:func:`stage_check`), then, on the card, each timed between
    two reads of variant 0 (K1, K2 or K3 on the same inputs: variant 0,
    variant, variant, variant 0), beside the floor at the case's bytes, its
    bound, SDPA's time and (with ``plain``) its plain version's; and the
    split of variant 0's time into stages. ``plain``: the headline case,
    whose plain versions are timed for the kernels line; ``ex2_dev``: the
    card's bf16 exponential against the correctly rounded one
    (:func:`ex2_deviation`)."""
    label, layout, B, N, H, d, nv, _ = case
    on_card = device == "cuda"
    t = time.perf_counter()
    q, k, v, cos, sin = inputs if rope else inputs[:3] + (None, None)
    scale = d ** -0.5
    n_valid = nv if nv < N else None
    default = {"fat": fa.fused_attention_fat, "packed": fa.fused_attention_packed,
               "headmajor": fa.fused_attention}[layout]

    def full():
        return default(q, k, v, scale, n_valid, cos, sin)

    out = {"phase": "stages", "what": label, "layout": layout, "shape": [B, N, H, d],
           "n_valid": nv, "rope": rope, "variants": {}}
    if on_card:
        out["clocks_before"] = gpu_clocks()
    want0 = full()
    v0_reads = []
    for variant in av.VARIANTS:
        def run(variant=variant):
            return av.attention_variant(q, k, v, scale, n_valid, cos, sin, variant=variant,
                                        layout=layout)

        got = run()
        if on_card:
            torch.cuda.synchronize()
        entry = stage_check(torch, av, variant, layout, q, k, v, scale, nv, cos, sin, got, want0,
                            ex2_dev)
        if on_card:
            reads = [time_ms(torch, f) for f in (full, run, run, full)]
            v0_reads += [reads[0], reads[3]]
            entry.update({"ms": (reads[1] + reads[2]) / 2, "ms_reads": reads[1:3],
                          "v0_ms_beside": (reads[0] + reads[3]) / 2},
                         **stage_bound(variant, B, N, H, d, nv, rope))
            entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
            entry["plain_ms"] = time_ms(torch, lambda: av.attention_variant_reference(
                q, k, v, scale, n_valid, cos, sin, variant=variant, layout=layout)) if plain else None
        out["variants"][variant] = entry
    out["ok"] = all(e["ok"] for e in out["variants"].values())
    if on_card:
        ms = {name: e["ms"] for name, e in out["variants"].items()}
        out["v0_ms"] = full_ms = sum(v0_reads) / len(v0_reads)
        out["floor_ms"] = floor_ms(torch, B * N * H * d, "bfloat16")
        out.update(attention_bound(B, N, H, d, nv, rope))
        out["sdpa_ms"], kernels = library_case(
            torch, fa, *(av.to_heads(t, layout) for t in (q, k, v)), scale, cos, sin)
        out["sdpa"] = sdpa_backend(kernels)
        copy = torch.empty_like(q)
        out["clone_ms"] = time_ms(torch, lambda: copy.copy_(q))  # o = q by one PyTorch call
        # qk's and nosm's products by torch.matmul on head-major copies (no
        # RoPE, no mask): q . k^T, and q . k^T then . V
        qh, kh, vh = (av.to_heads(t, layout).contiguous() for t in (q, k, v))
        out["matmul_qk_ms"] = time_ms(torch, lambda: torch.matmul(qh, kh.transpose(-1, -2)))
        out["matmul_qk_pv_ms"] = time_ms(
            torch, lambda: torch.matmul(torch.matmul(qh, kh.transpose(-1, -2)), vh))
        del qh, kh, vh
        out["split_ms"] = {
            "dma - floor": ms["dma"] - out["floor_ms"], "qk - dma": ms["qk"] - ms["dma"],
            "nosm - qk": ms["nosm"] - ms["qk"], "full - nosm": full_ms - ms["nosm"],
            "full - pipe": full_ms - ms["pipe"], "full - vext": full_ms - ms["vext"],
            "full - vext_bf16exp": full_ms - ms["vext_bf16exp"]}
        out["clocks_after"] = gpu_clocks()
    out["seconds"] = time.perf_counter() - t
    return out


def stage_phase(torch, cfg, device="cuda") -> dict:
    """Every STAGE_CASES case with RoPE and without (:func:`stage_case`),
    the variants' launch counts set to 0 before and read after: {"cases":
    [...], "launches": {variant: N}, "clocks": ..., "ex2": ..., "seconds":
    s}; "ex2" is :func:`ex2_deviation`'s report, read first. A failed check,
    or a variant never launched on the card, raises. (``device`` is "cpu"
    only in the CPU test, where the cases are cut: the plain versions on
    both sides, untimed.)"""
    from cbas_tpu_torch.ops import attention_variants as av
    from cbas_tpu_torch.ops import flash_attention as fa

    on_card = device == "cuda"
    t = time.perf_counter()
    clocks = {"before": gpu_clocks()} if on_card else {}
    ex2_dev, ex2 = ex2_deviation(torch, av) if on_card else (None, None)
    emit({"phase": "stages_ex2_bf16x2", **(ex2 or {})})
    av.launches = 0
    av.launches_by_variant.clear()
    cases = []
    for i, case in enumerate(STAGE_CASES):
        inputs = stage_inputs(torch, cfg, case, device)
        for rope in (True, False):
            cases.append(stage_case(torch, fa, av, case, inputs, rope, device,
                                    plain=rope and i == STAGE_HEADLINE[0], ex2_dev=ex2_dev))
            emit(cases[-1])
        del inputs
    launches = dict(av.launches_by_variant)
    if on_card:
        clocks["after"] = gpu_clocks()
    out = {"cases": cases, "launches": launches, "clocks": clocks, "ex2": ex2,
           "seconds": time.perf_counter() - t}
    emit({"phase": "stages_summary", "seconds": out["seconds"], "clocks": clocks,
          "launches": launches,
          "split_ms": [{"what": c["what"], "rope": c["rope"], "v0_ms": c.get("v0_ms"),
                        **c.get("split_ms", {})} for c in cases]})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"a stage variant disagrees with its yardstick: {bad}")
    if on_card and any(launches.get(name, 0) < len(cases) for name in av.VARIANTS):
        raise AssertionError(f"the stage phase launched the variants {launches} times")
    return out


def variants_kernel_entry(stages) -> dict:
    """The ``kernels`` line's entry for the stage variants: their launches
    over the stage phase, the headline variant's numbers at the headline
    case (STAGE_HEADLINE, with RoPE), every variant's there, and each case's
    times and split; the pipe loop's builds apart: ptxas's registers, spill
    bytes and serialization notes of each, and the stages, blocks an SM and
    resident blocks the library reports at 64 and 128."""
    from cbas_tpu_torch.ops import attention_variants as av

    index, headline = STAGE_HEADLINE
    label = STAGE_CASES[index][0]
    case = next(c for c in stages["cases"] if c["what"] == label and c["rope"])
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
            "v0_ms_beside")
    library = {"dma": case["clone_ms"], "qk": case["matmul_qk_ms"],
               "nosm": case["matmul_qk_pv_ms"], "pipe": case["sdpa_ms"], "vext": case["sdpa_ms"],
               "vext_bf16exp": case["sdpa_ms"]}
    variants = {name: {key: e[key] for key in keys} | {"library_ms": library.get(name)}
                for name, e in case["variants"].items()}
    return {
        "name": VARIANTS_KERNEL, "route": "cuda",
        "source": f"cbas_tpu_torch/csrc/{VARIANTS_KERNEL}.cu", "replaces": VARIANTS_REPLACES,
        "sites": list(VARIANTS_SITES), "launches": sum(stages["launches"].values()),
        "launches_by_variant": stages["launches"], "variant": headline, "what": label,
        "shape": case["shape"], "rope": True, **variants[headline],
        "library": f"scaled_dot_product_attention ({case['sdpa']}), RoPE applied beforehand; "
                   "dma: out.copy_(q); qk: torch.matmul(q, k^T); nosm: torch.matmul(q, k^T) "
                   "then . V (head-major copies, no RoPE)",
        "variants": variants,
        "cases": [{key: c[key] for key in ("what", "shape", "n_valid", "rope", "v0_ms",
                                           "floor_ms", "bound_ms", "sdpa_ms", "matmul_qk_ms",
                                           "matmul_qk_pv_ms", "split_ms")}
                  | {"ms": {name: e["ms"] for name, e in c["variants"].items()}}
                  for c in stages["cases"]],
        "clocks": stages["clocks"], "ex2_bf16x2": stages["ex2"], "seconds": stages["seconds"],
        "ptxas": list(PTXAS.get(VARIANTS_KERNEL, {}).items()),
        "pipe_ptxas": {k: v for k, v in PTXAS.get(VARIANTS_KERNEL, {}).items() if ", pipe" in k},
        "pipe_launch": {d: av.library_launch_config("pipe", d) for d in (64, 128)},
    }


# The persistent bf16 Hopper body at d 64 and 128 (source cbas_tpu_torch/csrc/
# attention_sm90_persistent.cuh, its entry csrc/attention_persistent.cu), a
# timing case no route calls: it measured slower than the one-warpgroup body
# K1-K3 run (PERF.md §6, PR 24). Its own path is its phase, run with its
# entry's count set to 0 before it and read after it: at the main paths' four
# shapes, on the inputs the kernel phase timed K1 and K3 on there (views of
# one fused projection, the model's tables), against the plain version and,
# bit for bit, against K1's or K3's wrapper; only the persistent body is
# timed here, the route's, the plain version's, SDPA's and the floor's times
# are the kernel phase's on the same inputs.
PERSISTENT_KERNEL = "attention_persistent"
PERSISTENT_SOURCE = "cbas_tpu_torch/csrc/attention_sm90_persistent.cuh"
PERSISTENT_REPLACES = "cbas_tpu/ops/flash_attention.py:728"
PERSISTENT_SITES = ("cbas_tpu/ops/flash_attention.py:728", "cbas_tpu/ops/flash_attention.py:522",
                    "cbas_tpu/ops/flash_attention.py:393")
PERSISTENT_SHAPES = (("attention_fat", BATCH_256, 261, 12, 64, (16, 16)),
                     ("attention_fat", BATCH_480, 1205, 12, 64, (30, 40)),
                     ("attention_headmajor", BATCH_7B_256, 261, 32, 128, (16, 16)),
                     ("attention_headmajor", BATCH_7B_480, 1205, 32, 128, (30, 40)))
# The numbers a persistent case takes from the kernel phase's case of its
# route at the same shape and inputs: {the persistent case's key: the
# kernel case's}.
PERSISTENT_FROM_ROUTE = {"one_warpgroup_ms": "ms", "one_warpgroup_ms_norope": "ms_norope",
                         "plain_ms": "plain_ms", "floor_ms": "floor_ms",
                         "library_ms": "library_ms", "library": "library"}


def persistent_case(torch, fa, ap, cfg, kernel, B, N, H, d, grid, route_case) -> dict:
    """The persistent body at one shape, on kernel_case's inputs there (views
    of one fused (B, N, 3*H*d) projection, the model's RoPE tables): against
    the plain version (KERNEL_BF16 tolerance) and bit for bit against the
    route's wrapper, one launch of the entry counted, timed with RoPE and
    without; ``route_case``, the kernel phase's case of that wrapper on the
    same inputs, gives the times beside it (PERSISTENT_FROM_ROUTE)."""
    layout = {"attention_fat": "fat", "attention_headmajor": "headmajor"}[kernel]
    wrapper, plain = {
        "attention_fat": (fa.fused_attention_fat, fa.attention_fat_reference),
        "attention_headmajor": (fa.fused_attention, fa.attention_headmajor_reference)}[kernel]
    rng = np.random.default_rng(SEED)  # kernel_case's inputs
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(
        "cuda", torch.bfloat16)
    q, k, v = (qkv[..., j * H * d:(j + 1) * H * d] for j in range(3))
    if layout == "headmajor":
        q, k, v = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
    cos, sin = head_tables(torch, cfg, d, grid, N)
    scale = d ** -0.5

    def run(tables=(cos, sin)):
        return ap.persistent_attention(q, k, v, scale, None, *tables, layout=layout)

    before = ap.launches
    got = run()
    launched, blocks = ap.launches - before, ap.last_blocks
    route = wrapper(q, k, v, scale, None, cos, sin)
    want = plain(q, k, v, scale, None, cos, sin)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    vmax = float(v.float().abs().max())
    tol = dtype_ulp(torch, want.float()) + KERNEL_BF16_VREL * vmax + KERNEL_BF16_FLOOR
    out = {"phase": "persistent", "name": kernel, "layout": layout, "shape": [B, N, H, d],
           "inputs": "views of one fused (B, N, 3*H*d) projection", "rope": True,
           "max_abs_err": float(err.max()),
           "tol": f"1 bf16 ulp + 2^-8 max|v| ({KERNEL_BF16_VREL * vmax:.3g}) + {KERNEL_BF16_FLOOR}",
           "bit_equal_one_warpgroup": bool(torch.equal(got, route)),
           "finite": bool(torch.isfinite(got).all()), "blocks": blocks, "launches": launched}
    out["ok"] = out["finite"] and bool((err <= tol).all()) and out["bit_equal_one_warpgroup"] \
        and launched == 1
    out["ms"] = time_ms(torch, run)
    out["ms_norope"] = time_ms(torch, lambda: run((None, None)))
    out.update({key: route_case[theirs] for key, theirs in PERSISTENT_FROM_ROUTE.items()})
    out.update(attention_bound(B, N, H, d, N, True))
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["clocks"] = gpu_clocks()
    return out


def persistent_phase(torch, fa, cfg, main_cases) -> dict:
    """The persistent body at PERSISTENT_SHAPES (its own path: its entry's
    count set to 0 before, read after), each beside ``main_cases``' fused
    case of its route at that shape (:func:`kernel_phase`); raises if a case
    disagrees."""
    from cbas_tpu_torch.ops import attention_persistent as ap

    t = time.perf_counter()
    ap.launches = 0
    cases = []
    for kernel, B, N, H, d, grid in PERSISTENT_SHAPES:
        route_case, = (c for c in main_cases[f"{kernel}_fused"]
                       if (c["B"], c["N"], c["H"], c["head_dim"]) == (B, N, H, d))
        cases.append(persistent_case(torch, fa, ap, cfg, kernel, B, N, H, d, grid, route_case))
        emit(cases[-1])
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"the persistent body disagrees: {bad}")
    return {"cases": cases, "launches": ap.launches, "seconds": time.perf_counter() - t}


def persistent_kernel_entry(persistent) -> dict:
    """The ``kernels`` line's entry for the persistent body: its launches
    over its phase, the headline case (K1 at 256x256, batch 128, with RoPE)
    and every case's numbers."""
    head = persistent["cases"][0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "one_warpgroup_ms", "one_warpgroup_ms_norope", "floor_ms",
            "share_of_bound", "bit_equal_one_warpgroup", "blocks")
    return {
        "name": "attention_sm90_persistent", "route": "cuda", "source": PERSISTENT_SOURCE,
        "replaces": PERSISTENT_REPLACES, "sites": list(PERSISTENT_SITES),
        "launches": persistent["launches"], "routed": False,
        "shape": head["shape"], "rope": True, **{key: head[key] for key in keys},
        "cases": [{key: c[key] for key in keys + ("shape", "name", "clocks")}
                  for c in persistent["cases"]],
        "ptxas": list(PTXAS.get(PERSISTENT_KERNEL, {}).items()),
        "seconds": persistent["seconds"],
    }


# The batched whole-row attention (source cbas_tpu_torch/csrc/attention_batched.cu,
# a timing kernel beside K1-K3: an item's whole K and V resident, an exact
# softmax, items batched a block) and the K-transposing relayout
# (cbas_tpu_torch/csrc/relayout.cu): the bodies of the head-major batched
# probes and probe26's relayout. Their own path is the batched phase, run with
# their counts set to 0 before it and read after it.
BATCHED_KERNEL, RELAYOUT_KERNEL = "attention_batched", "relayout"
BATCHED_REPLACES = "benchmarks/attn_probes/probe13_batched_dot_256.py:101"
BATCHED_SITES = tuple(f"benchmarks/attn_probes/{site}" for site in (
    "probe13_batched_dot_256.py:134", "probe16_variants_marginal_256.py:83",
    "probe21_batched_model_256.py:72", "probe26_layouts_256.py:90", "probe26_layouts_256.py:119",
    "probe26_layouts_256.py:208", "probe26b_gbbatch_256.py:104", "probe18_fat768_256.py:107",
    "probe18b_unroll_256.py:158", "probe19_fat_gridpair_256.py:88",
    "probe20_fat_model_256.py:95", "probe21_batched_model_256.py:160",
    "probe12_phase_split_256.py:139"))
# probe24's _fat_kernel_pairrope (:36) runs through K1's pallas_call
# (cbas_tpu/ops/flash_attention.py:728) and is K1's Pallas body line for line:
# the K1 route of the flat model A/B.
PAIRROPE_SITE = "benchmarks/attn_probes/probe24_pairrope_256.py:36"
RELAYOUT_REPLACES = "benchmarks/attn_probes/probe26_layouts_256.py:154"
RELAYOUT_SITE = "benchmarks/attn_probes/probe26_layouts_256.py:163"
# probe13's dma_kernel (:76) is the memory floor at its (384 * 6, 272, 128)
# blocks: the floor phase's first case (FLOOR_SHAPES).
BATCHED_FLOOR_CASE = "probe14/15 blocks (B*G, N, 128)"
BATCHED_INPUT_SCALE = 0.3  # the probes: standard normal x 0.3
# Its cases, each at its probe's own shape (B images, H heads of 64, N rows
# of which n_valid live; dead k and v rows hold NaN). "inputs": "packed"
# (B*G, N, 128) blocks read as head pairs; "headmajor" (B*H, N, 64); "flat"
# (B, N, H*64) q, k, v and output; "fused" head-major views of one fused (B,
# N, 3*H*64) projection (probe21's, with the model's RoPE tables); "kt"
# head-major q and v with K transposed to (B*H, 64, N); "fatq_kt" flat q, K
# and V transposed, a head-major output. "items": the items a block takes
# (the probes' 16 heads a program; probe26's and 26b's gb images' heads).
# "rope": None, "outside" (probe13's / probe16's rope_xla, then the kernel),
# "inside" with probe21's scaled tables ("scaled") or probe26b's plain ones
# ("plain"); "ropes": the RoPE settings timed. "scale": the softmax scale on
# the fp32 scores (probe26, 26b), else in q or none. The flat probes (18,
# 18b, 19) and probe12 rope inside with q's tables times the scale and k's
# plain ones, which at d 64 are probe21's ("scaled": bf16(cos 2^-3 2^3) =
# bf16(cos)), on standard normal tables. "pairgrid": flat q, k, v and output
# read as (G, B, 2, N, 64) views, so that a block's items run (pair, image,
# head) as probe19's grid over head pairs does. probe20's and probe21's fat
# kernels run in the model, on views of the fused projection at N 261 with
# the model's tables: their cases time that call. "sT": the transposed scores
# (the probes' pvt); "noexp": probe12's p = s - m.
BATCHED_CASES = (
    dict(what="probe13 qk_kernel", body="probe13_batched_dot_256.py:80", inputs="packed", B=384,
         H=12, N=272, nv=272, items=16, stage="qk", rope=None, ropes=(False,), scale=False),
    dict(what="probe13 qk_batched_kernel", body="probe13_batched_dot_256.py:94",
         inputs="headmajor", B=384, H=12, N=272, nv=272, items=16, stage="qk", rope=None,
         ropes=(False,), scale=False),
    dict(what="probe13/16 full_batched_kernel", body="probe13_batched_dot_256.py:101, "
         "probe16_variants_marginal_256.py:65", inputs="headmajor", B=384, H=12, N=272, nv=261,
         items=16, stage="full", rope="outside", ropes=(True, False), scale=False),
    dict(what="probe21 make_batched_kernel", body="probe21_batched_model_256.py:41",
         inputs="fused", B=384, H=12, N=261, nv=261, items=16, stage="full", rope="scaled",
         ropes=(True, False), scale=False),
    dict(what="probe26 batched_kernel", body="probe26_layouts_256.py:72", inputs="headmajor",
         B=448, H=12, N=272, nv=261, items=16, stage="full", rope=None, ropes=(False,),
         scale=True),
    dict(what="probe26 batched_kt_kernel", body="probe26_layouts_256.py:100", inputs="kt", B=448,
         H=12, N=272, nv=261, items=16, stage="full", rope=None, ropes=(False,), scale=True),
    dict(what="probe26 fatq_kt_kernel", body="probe26_layouts_256.py:182", inputs="fatq_kt",
         B=448, H=12, N=272, nv=261, items=48, stage="full", rope=None, ropes=(False,),
         scale=True),
    dict(what="probe26b gbbatch_kernel gb 4", body="probe26b_gbbatch_256.py:59", inputs="flat",
         B=448, H=12, N=272, nv=261, items=48, stage="full", rope="plain", ropes=(True, False),
         scale=True),
    dict(what="probe26b gbbatch_kernel gb 8", body="probe26b_gbbatch_256.py:59", inputs="flat",
         B=448, H=12, N=272, nv=261, items=96, stage="full", rope="plain", ropes=(True,),
         scale=True),
    *(dict(what=f"{probe} {body} {pvt}", body=f"{file}:{line}", inputs="flat", B=384, H=12,
           N=272, nv=261, items=48, stage="full", rope="scaled",
           ropes=(True, False) if pvt == "std" else (True,), scale=False, sT=pvt != "std")
      for probe, file, body, line, pvts in (
          ("probe18", "probe18_fat768_256.py", "fat_kernel", 47, ("std", "pvt")),
          ("probe18b", "probe18b_unroll_256.py", "fat_kernel", 47, ("std", "pvt")),
          ("probe18b", "probe18b_unroll_256.py", "fat_kernel_unroll", 104, ("pvt",)))
      for pvt in pvts),
    *(dict(what=f"probe20/21 make_fat_kernel {pvt}",
           body="probe20_fat_model_256.py:40, probe21_batched_model_256.py:118",
           inputs="fused", B=384, H=12, N=261, nv=261, items=48, stage="full", rope="scaled",
           ropes=(True,), scale=False, sT=pvt != "std")
      for pvt in ("std", "pvt")),
    *(dict(what=f"probe19 kernel {pvt}", body="probe19_fat_gridpair_256.py:39",
           inputs="pairgrid", B=384, H=12, N=272, nv=261, items=16, stage="full", rope="scaled",
           ropes=(True, False) if pvt == "std" else (True,), scale=False, sT=pvt != "std")
      for pvt in ("std", "pvt")),
    *(dict(what=f"probe12 phase_kernel {pvt}{', noexp' * noexp}",
           body="probe12_phase_split_256.py:49", inputs="packed", B=384, H=12, N=272, nv=261,
           items=16, stage="split", rope="scaled", ropes=(True,), scale=False, sT=pvt == "pvt",
           noexp=noexp)
      for noexp in (False, True) for pvt in ("std", "pvt")),
)
# The kernels line's headline: probe21's case with RoPE inside.
BATCHED_HEADLINE = "probe21 make_batched_kernel"
# The relayout's case: probe26's (448, 272, 768) flat k, with NaN in its dead rows.
RELAYOUT_SHAPE = (448, 272, 12, 64, 261)
# probe21's model case: dinov3-vitb16 at full width and depth, 256x256 at the
# flat phase's batch, through the port's _attention (K1 on fused views) and
# through the batched kernel with RoPE inside (vit._attention swapped in this
# script, as probe21 swaps it); the embeddings' cosine against the K1 route.
BATCHED_MODEL_MIN_COS = 0.999


def batched_bound(stage, items, N, nv, d, rope) -> dict:
    """The least time for a batched case's function: q.k^T (and p.V for the
    full stage) over the live keys at the bf16 peak, against q and o (N rows),
    k and v (n_valid rows) and, with RoPE inside, its four bf16 tables."""
    flop = (2 if stage == "qk" else 4) * items * N * nv * d
    nbytes = 2 * items * d * (2 * N + 2 * nv) + (4 * N * d * 2 if rope else 0)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"gflop": flop / 1e9, "mbytes": nbytes / 1e6, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def batched_tolerance(torch, ab, q, k, v, nv, score_scale, tables, k_transposed, v_transposed,
                      want, extra_ds=None, noexp=False):
    """The bound on |kernel - plain| of the full stage at each output element
    (q's shape), for operands as ``ab.attention_batched`` takes them. Both
    sides rope the same bf16 q and k (bf16 arithmetic, the same roundings) and
    round p, the output and nothing else; they differ by the orders of their
    fp32 sums and by their exponentials. So:

    - each score by ds = d 2^-22 sum_i |q_i k_i| |scale| (each side's sum of
      d exact products, at most 2 ulps of the running sum an add) plus 2^-23
      |s| (the product by the scale on each side), and ``extra_ds`` (the CPU
      tests' RoPE roundings);
    - the row max by at most s_m, the largest ds of a live key of the row;
    - each p = exp(s - m) by a factor within e^(+-e), e = ds + s_m + 2^-20
      (1 + |s - m| + |m|) (the kernel's 2^(s log2(e) - m log2(e)): its FFMA,
      the product m log2(e) and ex2.approx; the plain exp): its bf16 P lies
      between the roundings of p e^-e and p e^e (0 apart where both round
      alike), dP from the plain P;
    - the row sum l (unrounded p) by a relative dl = sum p expm1(e) / l + nv
      2^-22 (the two summation orders);
    - o = (P . V) / l by (sum dP |v| + nv 2^-22 sum (P + dP) |v|) / (l (1 -
      dl)) + |o| dl / (1 - dl) + 2^-21 |o| (the kernel's reciprocal and
      product, the plain division); then the output's rounding.

    Under ``noexp`` (p = s - m, every key below N in the sum, the dead ones
    at -1e30 - m) each live p moves by dp = ds + s_m + 2^-23 |s - m| (the
    score, the max and each side's rounding of the difference), its bf16 P
    lies between the roundings of p - dp and p + dp, and the sum of N terms
    of one sign by a relative dl = sum dp / |l| + N 2^-22. The transposed
    orientation is the same function: its sums run in another order, within
    the same terms."""
    ulp = functools.partial(dtype_ulp, torch)
    N, d = q.shape[-2:]
    kh = k.transpose(-1, -2) if k_transposed else k
    vh = v.transpose(-1, -2) if v_transposed else v
    qh = q
    if tables is not None:
        cq, sq, ck, sk = tables
        qh, kh = ab.rope_bf16(qh, cq, sq), ab.rope_bf16(kh, ck, sk)
    live = torch.arange(N, device=q.device) < nv
    qh = qh.float()
    kh = torch.where(live[:, None], kh.float(), 0.0)
    vh = torch.where(live[:, None], vh.float(), 0.0)
    s = (qh @ kh.transpose(-1, -2)) * score_scale
    ds = d * 2.0 ** -22 * abs(score_scale) * (qh.abs() @ kh.abs().transpose(-1, -2)) \
        + 2.0 ** -23 * s.abs()
    if extra_ds is not None:
        ds = ds + extra_ds
    ds = torch.where(live, ds, 0.0)
    s = torch.where(live, s, ab.MASKED)
    m = s.amax(-1, keepdim=True)
    x = s - m
    if noexp:
        p = x
        dp = torch.where(live, ds + ds.amax(-1, keepdim=True) + 2.0 ** -23 * x.abs(), 0.0)
        P = p.to(torch.bfloat16).float()
        dP = torch.maximum((p + dp).to(torch.bfloat16).float() - P,
                           P - (p - dp).to(torch.bfloat16).float())
        l = p.sum(-1, keepdim=True).abs()
        dl = dp.sum(-1, keepdim=True) / l + N * 2.0 ** -22
    else:
        e = torch.where(live, ds + ds.amax(-1, keepdim=True)
                        + 2.0 ** -20 * (1 + x.abs() + m.abs()), 0.0)
        p = torch.exp(x)
        P = p.to(torch.bfloat16).float()
        dP = torch.maximum((p * torch.exp(e)).to(torch.bfloat16).float() - P,
                           P - (p * torch.exp(-e)).to(torch.bfloat16).float())
        l = p.sum(-1, keepdim=True)
        dl = (p * torch.expm1(e)).sum(-1, keepdim=True) / l + nv * 2.0 ** -22
    va = vh.abs()
    o = (P @ vh).abs() / l
    dv = (dP @ va + nv * 2.0 ** -22 * ((P.abs() + dP) @ va)) / (l * (1 - dl)) \
        + o * dl / (1 - dl) + 2.0 ** -21 * o
    return dv + ulp(want.float().abs() + dv)


def batched_check(torch, ab, case, q, k, v, score_scale, tables, got) -> dict:
    """``got`` against the plain version: the qk stage bit for bit q, the full
    stage within :func:`batched_tolerance`, in chunks of images whose scores
    fit in 512 MiB of fp32."""
    if case["stage"] == "qk":
        ok = bool(torch.equal(got.view(torch.int16), q.view(torch.int16)))
        return {"max_abs_err": float((got.float() - q.float()).abs().max()),
                "tol": "bit-equal to q", "ok": ok}
    N, nv, scale = q.shape[-2], case["nv"], score_scale
    kt, vt = case["inputs"] in ("kt", "fatq_kt"), case["inputs"] == "fatq_kt"
    st, noexp = case.get("sT", False), case.get("noexp", False)
    per_image = q[0].numel() // q.shape[-1]  # the rows of one image's items
    chunk = max(1, 2 ** 29 // (4 * per_image * N))
    err, worst, ok = 0.0, 0.0, bool(torch.isfinite(got).all())
    for b0 in range(0, q.shape[0], chunk):
        part = [t[b0:b0 + chunk] for t in (q, k, v)]
        want = ab.attention_batched_reference(*part, nv, scale, tables, stage=case["stage"],
                                              k_transposed=kt, v_transposed=vt,
                                              transposed_scores=st, noexp=noexp)
        tol = batched_tolerance(torch, ab, *part, nv, scale, tables, kt, vt, want, noexp=noexp)
        e = (got[b0:b0 + chunk].float() - want.float()).abs()
        err, worst = max(err, float(e.max())), max(worst, float((e / tol).max()))
        ok = ok and bool((e <= tol).all())
    return {"max_abs_err": err, "max_err_over_tol": worst,
            "tol": "batched_tolerance (chip_smoke.py)", "ok": ok}


def batched_inputs(torch, cfg, case, device="cuda") -> dict:
    """A BATCHED_CASES case's operands, drawn on ``device`` from a seeded
    generator (the probes' standard normal x 0.3, standard normal (N, 64)
    tables; the model's tables and unscaled normals for probe21's fused
    views), NaN in k's and v's rows at or past n_valid, in the case's
    layout: {"q", "k", "v", "out", "cos", "sin", "heads": head-major (B, H,
    N, 64) copies of q, k and v for K3 and SDPA, "flat": (B, N, H*64) ones for
    K1 where the inputs are flat}. "pairgrid" q, k, v: (G, B, 2, N, 64)
    views of flat tensors, a block's items in (pair, image, head) order."""
    B, H, N, nv, d = case["B"], case["H"], case["N"], case["nv"], 64
    gen = torch.Generator(device).manual_seed(SEED + 3)

    def normal(*shape, scale=BATCHED_INPUT_SCALE):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    out = {"out": None}
    if case["inputs"] == "fused":
        qkv = normal(B, N, 3 * H * d, scale=1.0)
        flat = [qkv[..., j * H * d:(j + 1) * H * d] for j in range(3)]
        cos, sin = rope_full(torch, cfg, d, (16, 16), N, device)
    else:
        flat = [normal(B, N, H * d) for _ in range(3)]
        cos, sin = (torch.randn(N, d, generator=gen, device=device) for _ in range(2))
    for t in flat[1:]:
        t[:, nv:] = float("nan")
    heads = [t.view(B, N, H, d).transpose(1, 2) for t in flat]
    out["heads"] = [t.contiguous() for t in heads]
    if case["inputs"] in ("flat", "fused"):
        out["q"], out["k"], out["v"] = heads  # views: flat strides, or the fused buffer's
    elif case["inputs"] == "pairgrid":  # (G, B, 2, N, 64) views of the flat tensors
        out["q"], out["k"], out["v"] = (t.view(B, N, H // 2, 2, d).permute(2, 0, 3, 1, 4)
                                        for t in flat)
    elif case["inputs"] == "packed":  # (B*G, N, 128) blocks as (B, G, 2, N, 64) head pairs
        blocks = [t.view(B, N, H // 2, 2 * d).transpose(1, 2).contiguous() for t in flat]
        out["q"], out["k"], out["v"] = (t.view(B, H // 2, N, 2, d).transpose(2, 3) for t in blocks)
        out["packed"] = blocks
    else:
        out["q"], out["k"], out["v"] = out["heads"]
        transposed = [t.transpose(-1, -2).contiguous() for t in out["heads"]]  # (B, H, 64, N)
        if case["inputs"] == "kt":
            out["k"] = transposed[1]
        if case["inputs"] == "fatq_kt":
            out["q"], out["k"], out["v"] = heads[0], transposed[1], transposed[2]
            out["out"] = torch.empty(B * H, N, d, dtype=torch.bfloat16,
                                     device=device).view(B, H, N, d)
    out["cos"], out["sin"] = cos, sin
    return out


def batched_calls(ab, case, inputs, rope):
    """(kernel call, plain call, tables) of a case with RoPE or without: the
    RoPE outside applied in plain torch before the kernel (probe13's and
    probe16's jit'd rope_xla), or the kernel's bf16 tables."""
    d = 64
    scale = d ** -0.5
    q, k, v, out = inputs["q"], inputs["k"], inputs["v"], inputs["out"]
    cos, sin = inputs["cos"], inputs["sin"]
    kw = dict(stage=case["stage"], k_transposed=case["inputs"] in ("kt", "fatq_kt"),
              v_transposed=case["inputs"] == "fatq_kt", transposed_scores=case.get("sT", False),
              noexp=case.get("noexp", False))
    nv, tables = case["nv"], None
    s_scale = scale if case["scale"] else 1.0
    if rope and case["rope"] in ("scaled", "plain"):
        tables = ab.rope_tables(cos, sin, scale, d ** 0.5) if case["rope"] == "scaled" \
            else ab.rope_tables(cos, sin)
    elif not rope and case["rope"] == "scaled":
        s_scale = scale  # without the tables, the scale goes on the scores
    if rope and case["rope"] == "outside":
        def kernel():
            return ab.attention_batched(ab.rope_outside(q, cos, sin, scale),
                                        ab.rope_outside(k, cos, sin), v, nv, s_scale,
                                        items=case["items"], out=out, **kw)

        def plain():
            return ab.attention_batched_reference(ab.rope_outside(q, cos, sin, scale),
                                                  ab.rope_outside(k, cos, sin), v, nv, s_scale,
                                                  **kw)
    else:
        def kernel():
            return ab.attention_batched(q, k, v, nv, s_scale, tables, items=case["items"],
                                        out=out, **kw)

        def plain():
            return ab.attention_batched_reference(q, k, v, nv, s_scale, tables, **kw)
    return kernel, plain, tables, s_scale


def batched_case(torch, fa, ab, case, inputs, device="cuda") -> dict:
    """One BATCHED_CASES case, RoPE on and off as it has them: the kernel
    against its plain version (:func:`batched_check`; the RoPE outside on
    both sides' inputs alike), then, on the card, timed between two reads of
    K3 on the same head-major data, or K2 on packed blocks, or K1 on flat
    inputs (baseline, kernel, kernel, baseline), beside its bound, the
    floor at its bytes, the library call (SDPA with the key mask on
    head-major copies, RoPE applied beforehand; for the qk stage q . k^T by
    torch.matmul) and its plain version, the SM clock sampled around it."""
    on_card = device == "cuda"
    B, H, N, nv, d = case["B"], case["H"], case["N"], case["nv"], 64
    scale = d ** -0.5
    out = {"phase": "batched", "what": case["what"], "body": case["body"],
           "inputs": case["inputs"], "shape": [B, H, N, d], "n_valid": nv,
           "items": case["items"], "stage": case["stage"], "rope": case["rope"], "ropes": {}}
    if on_card:
        out["clocks_before"] = gpu_clocks()
    cos, sin = inputs["cos"], inputs["sin"]
    live_n = nv if nv < N else None
    if case["inputs"] == "packed":
        base_args, base = inputs["packed"], fa.fused_attention_packed
        out["baseline"] = "K2 (packed blocks)"
    elif case["inputs"] in ("flat", "fatq_kt", "pairgrid"):
        base_args = [t.transpose(1, 2).reshape(B, N, H * d) for t in inputs["heads"]]
        base, out["baseline"] = fa.fused_attention_fat, "K1 (flat)"
    else:
        base_args, base = inputs["heads"], fa.fused_attention
        out["baseline"] = "K3 (head-major)"
    for rope in case["ropes"]:
        kernel, plain, tables, s_scale = batched_calls(ab, case, inputs, rope)
        before = ab.launches
        got = kernel()
        if on_card:
            torch.cuda.synchronize()
        q, k = inputs["q"], inputs["k"]
        if rope and case["rope"] == "outside":
            q, k = ab.rope_outside(q, cos, sin, scale), ab.rope_outside(k, cos, sin)
        entry = batched_check(torch, ab, case, q, k, inputs["v"], s_scale, tables, got)
        entry["launches"] = ab.launches - before
        entry["ok"] = entry["ok"] and entry["launches"] == int(on_card)
        if on_card:
            tabs = (cos, sin) if rope else (None, None)

            def baseline(tabs=tabs):
                return base(*base_args, scale, live_n, *tabs)

            reads = [time_ms(torch, f) for f in (baseline, kernel, kernel, baseline)]
            entry.update({"ms": (reads[1] + reads[2]) / 2, "ms_reads": reads[1:3],
                          "baseline_ms": (reads[0] + reads[3]) / 2},
                         **batched_bound(case["stage"], B * H, N, nv, d, tables is not None))
            # The same call with the items spread so that every SM takes one
            # block (one wave): the probe's program size against the card's.
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            entry["items_one_wave"] = -(-B * H // sms)
            entry["ms_one_wave"] = time_ms(torch, batched_calls(
                ab, dict(case, items=entry["items_one_wave"]), inputs, rope)[0])
            entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
            entry["plain_ms"] = time_ms(torch, plain, iters=5, warmup=1)
            entry["library_ms"] = (None if case.get("noexp") else
                                   batched_library_ms(torch, fa, case, inputs, rope))
        out["ropes"]["rope" if rope else "no_rope"] = entry
    out["ok"] = all(e["ok"] for e in out["ropes"].values())
    if on_card:
        out["floor_ms"] = floor_ms(torch, B * H * N * d, "bfloat16")
        out["library"] = ("torch.matmul(q, k^T)" if case["stage"] == "qk" else
                          "none: no PyTorch call takes p = s - m" if case.get("noexp") else
                          "scaled_dot_product_attention, key mask")
        out["ptxas"] = batched_ptxas(case, rope=case["rope"] in ("scaled", "plain"))
        out["clocks_after"] = gpu_clocks()
    return out


def batched_library_ms(torch, fa, case, inputs, rope) -> float:
    """The library call's ms on head-major contiguous copies: q . k^T by
    torch.matmul for the qk stage, else SDPA with the key mask, RoPE applied
    beforehand in fp32 and the scale passed in. The port never calls it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, k, v = inputs["heads"]
    if case["stage"] == "qk":
        return time_ms(torch, lambda: torch.matmul(q, k.transpose(-1, -2)))
    if rope:
        cos, sin = inputs["cos"], inputs["sin"]
        q, k = ((t.float() * cos + fa.rotate_half(t.float()) * sin).to(t.dtype) for t in (q, k))
    mask = (torch.arange(q.shape[-2], device=q.device) < case["nv"])[None, None, None, :]
    return time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask, scale=q.shape[-1] ** -0.5))


def batched_ptxas(case, rope) -> str:
    """Registers and spills of the kernel instantiation a case runs, from PTXAS."""
    label = batched_label(case["stage"], rope, case["inputs"] in ("kt", "fatq_kt"),
                          case["inputs"] == "fatq_kt", case.get("sT", False),
                          case.get("noexp", False))
    return PTXAS.get(BATCHED_KERNEL, {}).get(label, "not in the build log")


def batched_label(stage, rope, k_transposed, v_transposed, transposed_scores=False,
                  noexp=False) -> str:
    """A batched kernel instantiation's name in :func:`ptxas_report`."""
    from cbas_tpu_torch.ops.attention_batched import option_set

    return f"batched<{option_set(stage, rope, k_transposed, v_transposed, transposed_scores, noexp)}>"


def relayout_case(torch, rl, device="cuda") -> dict:
    """probe26's relayout at RELAYOUT_SHAPE on a flat k with NaN in its dead
    rows, bit for bit against its plain version; on the card timed beside
    the library call (the same permute made contiguous), the floor at its
    bytes (q, k, v and o of half its elements) and its byte bound."""
    B, N, H, d, nv = RELAYOUT_SHAPE
    gen = torch.Generator(device).manual_seed(SEED + 4)
    x = (torch.randn(B, N, H * d, generator=gen, device=device) * BATCHED_INPUT_SCALE).to(
        torch.bfloat16)
    x[:, nv:] = float("nan")
    before = rl.launches
    got = rl.relayout_kt(x, H)
    want = rl.relayout_kt_reference(x, H)
    out = {"phase": "batched_relayout", "what": "probe26 relayout_kt_kernel",
           "body": "probe26_layouts_256.py:154", "shape": [B, N, H * d], "heads": H,
           "bit_equal": bool(torch.equal(got.view(torch.int16), want.view(torch.int16))),
           "shape_out": list(got.shape), "launches": rl.launches - before}
    out["max_abs_err"] = 0.0 if out["bit_equal"] else float("nan")
    out["ok"] = out["bit_equal"] and out["launches"] == int(device == "cuda")
    if device == "cuda":
        nbytes = 2 * x.numel() * x.element_size()
        out["ms"] = time_ms(torch, lambda: rl.relayout_kt(x, H))
        out["plain_ms"] = time_ms(torch, lambda: rl.relayout_kt_reference(x, H))
        view = x.view(B, N, H, d)
        out["library_ms"] = time_ms(torch, lambda: view.permute(0, 2, 3, 1).contiguous())
        out["library"] = "x.view(B, N, H, d).permute(0, 2, 3, 1).contiguous()"
        out["floor_ms"] = floor_ms(torch, x.numel() // 2, "bfloat16")
        out["mbytes"], out["bound_ms"], out["bound_by"] = nbytes / 1e6, 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        out["gbps"] = nbytes / out["ms"] / 1e6
        out["ptxas"] = PTXAS.get(RELAYOUT_KERNEL, {}).get("relayout_kt", "not in the build log")
    return out


def batched_attention(params, prefix, x, cfg, rope, items=16, transposed_scores=False):
    """probe21's batched_attention on the port's model: ``vit._attention``
    with its one q|k|v projection GEMM, the head-major views of its output
    handed to the batched kernel with RoPE inside (probe21's tables: q's times
    the scale, k's times sqrt(d) after it; the scale on the scores without
    RoPE), ``items`` a block, the scores transposed where asked, the context
    back through the out-projection. Swapped in by :func:`batched_model_case`
    and :func:`flat_model_case` only: no route of the package calls it."""
    import torch.nn.functional as F

    from cbas_tpu_torch.models import vit
    from cbas_tpu_torch.ops import attention_batched as ab

    B, N, _ = x.shape
    hd = cfg.head_dim
    _, _, out_name, out_bias = vit._attn_param_table(cfg, prefix)
    weight, bias = vit._fused_qkv(params, prefix)
    HD = weight.shape[0] // 3
    qkv = F.linear(x, weight, bias)
    vit._count_gemm("qkv")
    q, k, v = (qkv[..., j * HD:(j + 1) * HD].view(B, N, HD // hd, hd).transpose(1, 2)
               for j in range(3))
    tables = ab.rope_tables(*rope, hd ** -0.5, hd ** 0.5) if rope is not None else None
    ctx = ab.attention_batched(q, k, v, None, 1.0 if tables else hd ** -0.5, tables, items=items,
                               transposed_scores=transposed_scores)
    return vit._dense_reduce(params, out_name, ctx.transpose(1, 2).reshape(B, N, HD), out_bias,
                             cfg.hidden_size)


@contextlib.contextmanager
def swapped_attention(fn):
    """``vit._attention`` replaced by ``fn`` inside the block, restored after."""
    from cbas_tpu_torch.models import vit

    original = vit._attention
    vit._attention = fn
    try:
        yield
    finally:
        vit._attention = original


def batched_model_case(torch, enc, planes, batch, device="cuda", reps=4) -> dict:
    """probe21's model A/B: ``enc`` over ``planes`` through the port's
    ``_attention`` (K1 on fused views) and with :func:`batched_attention`
    swapped in for it, in one process: the embeddings' cosine, the batched
    kernel's launches a forward (one a full block: L - 1), and on the card
    warm frames/s in the order K1, batched, batched, K1."""
    from cbas_tpu_torch.ops import attention_batched as ab

    k1 = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
    before = ab.launches
    with swapped_attention(batched_attention):
        got = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
    launches = ab.launches - before
    cos = row_cosine(k1, got)
    layers = enc.cfg.num_layers
    out = {"phase": "batched_model", "what": "probe21 model A/B", "encoder": enc.identifier,
           "frames": batch, "batch": batch, "launches_a_forward": launches,
           "expected_launches_a_forward": (layers - 1) * int(device == "cuda"),
           "min_cos_vs_k1": float(cos.min()), "tol_min_cos": BATCHED_MODEL_MIN_COS,
           "finite": bool(np.isfinite(got).all())}
    out["ok"] = out["finite"] and out["min_cos_vs_k1"] >= BATCHED_MODEL_MIN_COS \
        and launches == out["expected_launches_a_forward"]
    if device == "cuda":
        reads = []
        for route in ("K1", "batched", "batched", "K1"):
            with (swapped_attention(batched_attention) if route == "batched"
                  else contextlib.nullcontext()):
                reads.append(warm_fps(torch, enc, planes, batch, reps))
        out["fps_reads"] = {"order": ["K1", "batched", "batched", "K1"], "fps": reads}
        out["fps_k1"], out["fps_batched"] = (reads[0] + reads[3]) / 2, (reads[1] + reads[2]) / 2
    return out


# The flat model A/B of probe20 (:95, pvt off and on), probe21 (:160, its fat
# kernel: pvt) and probe24 (:36, K1's body): dinov3-vitb16 at full width and
# depth, 256x256, at the probes' batch, through K1 (the port's _attention)
# and the batched kernel on views of the fused projection at gb 4 images (48
# items) a block, in the row orientation (full+rope) and the transposed one
# (full+rope+sT). Reads: K1, std, sT, sT, std, K1.
FLAT_MODEL_BATCH, FLAT_MODEL_ITEMS = 384, 48
FLAT_MODEL_ROUTES = {"std": ("full+rope", False), "sT": ("full+rope+sT", True)}
FLAT_MODEL_READS = ("K1", "std", "sT", "sT", "std", "K1")


def flat_model_case(torch, enc, planes, batch, device="cuda", reps=4) -> dict:
    """The flat model A/B (FLAT_MODEL_ROUTES against K1) in one process: each
    route's embeddings' cosine against K1's, its option set's launches a
    forward (L - 1), and on the card warm frames/s in FLAT_MODEL_READS'
    order, each route's the mean of its two reads."""
    from cbas_tpu_torch.ops import attention_batched as ab

    fns = {name: functools.partial(batched_attention, items=FLAT_MODEL_ITEMS,
                                   transposed_scores=st)
           for name, (_, st) in FLAT_MODEL_ROUTES.items()}
    k1 = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
    expected = (enc.cfg.num_layers - 1) * int(device == "cuda")
    out = {"phase": "batched_flat_model", "what": "probe20/21/24 flat model A/B",
           "sites": ["probe20_fat_model_256.py:95", "probe21_batched_model_256.py:160",
                     PAIRROPE_SITE.split("/")[-1]],
           "encoder": enc.identifier, "batch": batch, "items": FLAT_MODEL_ITEMS,
           "expected_launches_a_forward": expected, "tol_min_cos": BATCHED_MODEL_MIN_COS,
           "routes": {}}
    for name, (option, _) in FLAT_MODEL_ROUTES.items():
        before = dict(ab.launches_by_option)
        with swapped_attention(fns[name]):
            got = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
        launches = {o: n - before.get(o, 0) for o, n in ab.launches_by_option.items()
                    if n != before.get(o, 0)}
        r = {"option_set": option, "launches_a_forward": launches.get(option, 0),
             "other_launches": {o: n for o, n in launches.items() if o != option},
             "min_cos_vs_k1": float(row_cosine(k1, got).min()),
             "finite": bool(np.isfinite(got).all())}
        r["ok"] = r["finite"] and r["min_cos_vs_k1"] >= BATCHED_MODEL_MIN_COS \
            and r["launches_a_forward"] == expected and not r["other_launches"]
        out["routes"][name] = r
    out["ok"] = all(r["ok"] for r in out["routes"].values())
    if device == "cuda":
        reads = []
        for route in FLAT_MODEL_READS:
            with (swapped_attention(fns[route]) if route in fns else contextlib.nullcontext()):
                reads.append(warm_fps(torch, enc, planes, batch, reps))
        out["fps_reads"] = {"order": list(FLAT_MODEL_READS), "fps": reads}
        out["fps"] = {route: sum(f for r, f in zip(FLAT_MODEL_READS, reads) if r == route) / 2
                      for route in dict.fromkeys(FLAT_MODEL_READS)}
    return out


def batched_phase(torch, cfg, device="cuda") -> dict:
    """Every BATCHED_CASES case (:func:`batched_case`), the relayout
    (:func:`relayout_case`), probe21's model case
    (:func:`batched_model_case`, dinov3-vitb16 at 256x256 and BATCH_256) and
    the flat model A/B (:func:`flat_model_case`, FLAT_MODEL_BATCH), the
    kernels' launch counts set to 0 before and read after: {"cases",
    "relayout", "model", "flat_model", "launches", "launches_relayout",
    "seconds"}. A failed check, or a kernel or an option set of BUILT never
    launched on the card, raises. (``device``
    is "cpu" only in the CPU test, where the cases and the model are cut: the
    plain versions on both sides, untimed.)"""
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.ops import attention_batched as ab
    from cbas_tpu_torch.ops import flash_attention as fa
    from cbas_tpu_torch.ops import relayout as rl

    on_card = device == "cuda"
    t = time.perf_counter()
    ab.launches, rl.launches = 0, 0
    ab.launches_by_option.clear()
    cases = []
    for case in BATCHED_CASES:
        inputs = batched_inputs(torch, cfg, case, device)
        cases.append(batched_case(torch, fa, ab, case, inputs, device))
        emit(cases[-1])
        del inputs
    relayout = relayout_case(torch, rl, device)
    emit(relayout)
    if on_card:
        enc = FrameEncoder(ENCODER, cfg=cfg, random_init=True, device="cuda")
        batch = BATCH_256
    else:
        enc, batch = FrameEncoder(ENCODER, cfg=cfg, random_init=True, device="cpu"), 2
    flat_batch = FLAT_MODEL_BATCH if on_card else batch
    planes = np.random.default_rng(SEED).integers(0, 256, (flat_batch, 256, 256), np.uint8)
    model = batched_model_case(torch, enc, planes, batch, device)
    emit(model)
    flat_model = flat_model_case(torch, enc, planes, flat_batch, device)
    emit(flat_model)
    out = {"cases": cases, "relayout": relayout, "model": model, "flat_model": flat_model,
           "launches": dict(ab.launches_by_option), "launches_relayout": rl.launches,
           "seconds": time.perf_counter() - t}
    emit({"phase": "batched_summary", "seconds": out["seconds"], "launches": out["launches"],
          "launches_relayout": rl.launches, "floor_case": BATCHED_FLOOR_CASE,
          "ms": [{"what": c["what"], **{r: {key: e.get(key) for key in (
              "ms", "ms_one_wave", "baseline_ms", "bound_ms", "plain_ms", "library_ms")}
              for r, e in c["ropes"].items()}} for c in cases]})
    bad = [c for c in cases + [relayout, model, flat_model] if not c["ok"]]
    if bad:
        raise AssertionError(f"a batched case disagrees with its yardstick: {bad}")
    unlaunched = sorted(ab.option_set(*o) for o in ab.BUILT
                        if ab.option_set(*o) not in out["launches"])
    if on_card and (unlaunched or not rl.launches):
        raise AssertionError(f"the batched phase launched {out['launches']} (never: "
                             f"{unlaunched}) and the relayout {rl.launches} times")
    return out


def batched_kernel_entries(batched) -> list:
    """The ``kernels`` line's entries of the batched kernel and the
    relayout: their launches over the batched phase, the headline case's
    numbers (BATCHED_HEADLINE, RoPE inside), every case's, and the model
    A/B."""
    case = next(c for c in batched["cases"] if c["what"] == BATCHED_HEADLINE)
    head = case["ropes"]["rope"]
    keys = ("launches", "max_abs_err", "max_err_over_tol", "ms", "baseline_ms", "plain_ms",
            "bound_ms", "bound_by", "share_of_bound", "library_ms", "items_one_wave",
            "ms_one_wave")
    rel = batched["relayout"]
    return [{
        "name": BATCHED_KERNEL, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{BATCHED_KERNEL}.cu",
        "replaces": BATCHED_REPLACES, "sites": list(BATCHED_SITES),
        "launches": sum(batched["launches"].values()), "launches_by_option": batched["launches"],
        "what": case["what"], "shape": case["shape"], "rope": "inside",
        **{key: head[key] for key in keys if key != "launches"},
        "floor_ms": case["floor_ms"], "library": case["library"], "ptxas": case["ptxas"],
        "floor_case": BATCHED_FLOOR_CASE,
        "cases": [{key: c[key] for key in ("what", "body", "inputs", "shape", "n_valid", "items",
                                           "stage", "baseline", "floor_ms", "ptxas")}
                  | {r: {key: e[key] for key in keys if key in e} for r, e in c["ropes"].items()}
                  for c in batched["cases"]],
        "model": batched["model"], "flat_model": batched["flat_model"],
        "pairrope_site": PAIRROPE_SITE, "seconds": batched["seconds"],
        "ptxas_all": list(PTXAS.get(BATCHED_KERNEL, {}).items()),
    }, {
        "name": RELAYOUT_KERNEL, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{RELAYOUT_KERNEL}.cu",
        "replaces": RELAYOUT_REPLACES, "sites": [RELAYOUT_SITE],
        "launches": batched["launches_relayout"], "shape": rel["shape"],
        **{key: rel[key] for key in ("max_abs_err", "bit_equal", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "share_of_bound", "library_ms", "library",
                                     "floor_ms", "gbps", "ptxas")},
    }]


# The streamed transposed-score attention (source cbas_tpu_torch/csrc/attention_pvt.cu,
# a timing kernel beside K1-K3: the keys streamed through a ring, an exact
# softmax down the key axis in two passes): the bodies of the transposed-score
# probes at the 640x480 geometry. Its own path is the pvt phase, run with its
# counts set to 0 before it and read after it.
PVT_KERNEL = "attention_pvt"
PVT_REPLACES = "benchmarks/attn_probes/probe3.py:60"
PVT_SITES = tuple(f"benchmarks/attn_probes/{site}" for site in (
    "probe3.py:42", "probe5.py:44", "probe6_pvt_interleaved.py:60", "probe4.py:46",
    "probe23_fat_480p.py:92"))
# The probes' inputs: (B*G, N, 128) bf16 head-pair blocks of B images of 12
# heads, N 1216 of which 1205 live (NaN in k's and v's dead rows), standard
# normal x 0.3, standard normal (N, 64) tables (q's times the scale inside,
# k's plain: rope_tables(cos, sin, scale, sqrt(d))), read as (B, G, 2, N, 64)
# views. Each case: the body, its form and bf16exp, and gp, the head pairs a
# program (items = 2 gp heads a block).
PVT_SHAPE = (320, 12, 1216, 1205)  # B images, H heads of 64, N, live keys
PVT_CASES = (
    *(dict(what=f"probe3 pvt_kernel gp {gp}", body="probe3.py:60", form="std", bf16exp=False,
           gp=gp) for gp in (8, 4)),
    *(dict(what=f"probe5 pvt_kernel{name}", body="probe5.py:62", form=form, bf16exp=bf16exp,
           gp=gp)
      for name, form, bf16exp, gp in (
          ("", "rounded", False, 4), (" bf16exp", "rounded", True, 4), (" vext", "vext", False, 4),
          (" bf16exp+vext gp 4", "vext", True, 4), (" bf16exp+vext gp 8", "vext", True, 8))),
    *(dict(what=f"probe4 pvt_vext_kernel{name}", body="probe4.py:118", form="vext",
           bf16exp=bf16exp, gp=gp)
      for name, bf16exp, gp in ((" f32exp", False, 4), (" bf16exp gp 4", True, 4),
                                (" bf16exp gp 8", True, 8))),
)
PVT_HEADLINE = "probe3 pvt_kernel gp 8"
# probe6: interleaved rounds of K2 and the std form at gp 8, 6 timed calls
# each after one warm-up, the median ratio pvt / K2.
PVT_ROUNDS, PVT_ROUND_CALLS = 10, 6
# probe23's model A/B at 640x480: each model at full width and depth at the
# probe's batch, random weights, through K1 (the port's _attention) and the
# std form on views of the fused projection with the model's tables (one
# image's heads a block, probe23's gb 1); reads K1, pvt, pvt, K1.
PVT_MODELS = (("dinov3-vitb16", 320), ("dinov3-vitl16", 96))
PVT_MODEL_READS = ("K1", "pvt", "pvt", "K1")
PVT_MODEL_REPS = 3


def pvt_bound(items, N, nv, d) -> dict:
    """The least time for a pvt case's function: q.k^T and p.V over the live
    keys at the bf16 peak, against q and o (N rows), k and v (n_valid rows)
    and the four bf16 tables."""
    flop = 4 * items * N * nv * d
    nbytes = 2 * items * d * (2 * N + 2 * nv) + 4 * N * d * 2
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"gflop": flop / 1e9, "mbytes": nbytes / 1e6, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def pvt_tolerance(torch, ap, q, k, v, nv, tables, want, form, bf16exp, extra_ds=None,
                  ex2_dev=None):
    """The bound on |kernel - plain| of the streamed transposed-score
    attention at each output element (q's shape), for head-major operands.
    Both sides rope the same bf16 q and k (bf16 arithmetic, the same
    roundings); they differ by the orders of their fp32 sums, their
    exponentials and, under ``bf16exp``, where the exponent is rounded. So
    (natural-log units):

    - each score by ds = d 2^-22 sum_i |q_i k_i| (each side's sum of d exact
      products, at most 2 ulps of the running sum an add), and ``extra_ds``
      (the CPU tests' RoPE roundings); the column max by at most s_m, the
      largest ds of a live key of the column; so x = s - m by e = ds + s_m +
      2^-20 (1 + |x| + |m|) (the kernel's 2^(s log2(e) - m log2(e)): its FFMA,
      the product m log2(e) and ex2.approx; the plain exp);
    - each bf16 P on either side lies in the range its rounding points give
      x +- e: bf16(exp(x +- e)) (ex2.approx in fp32 or the plain exp); under
      ``bf16exp`` the plain side's bf16(exp(bf16(x +- e))) and the kernel's
      2^bf16((x +- e) log2(e)) correctly rounded, widened by the card's
      ex2.approx.ftz.bf16x2 against that (``ex2_dev``, |ln(card / plain)| by
      the argument's bit pattern, :func:`ex2_deviation`; None where it is
      taken as correctly rounded, as in the CPU tests). dP, the width of the
      union of both ranges, bounds |P_kernel - P_plain|;
    - the column sum l: "std" of the unrounded p = exp(x), by a relative dl =
      sum p expm1(e) / l + nv 2^-22 (two fp32 orders); "rounded" and "vext"
      of the bf16 P (vext's as the ones row of the product: the same terms),
      by dl = sum dP / l + nv 2^-22 (1 + sum dP / l);
    - o = (P . V) / l by (sum dP |v| + nv 2^-22 sum (P + dP) |v|) / (l (1 -
      dl)) + |o| dl / (1 - dl) + 2^-21 |o| (each side's division); then the
      output's rounding."""
    from cbas_tpu_torch.ops import attention_batched as ab
    from cbas_tpu_torch.ops import attention_variants as av

    ulp = functools.partial(dtype_ulp, torch)
    N, d = q.shape[-2:]
    qh, kh = ab.rope_bf16(q, *tables[:2]), ab.rope_bf16(k, *tables[2:])
    live = torch.arange(N, device=q.device) < nv
    qh = qh.float()
    kh = torch.where(live[:, None], kh.float(), 0.0)
    vh = torch.where(live[:, None], v.float(), 0.0)
    s = qh @ kh.transpose(-1, -2)  # (queries, keys): the function is one in either orientation
    ds = d * 2.0 ** -22 * (qh.abs() @ kh.abs().transpose(-1, -2))
    if extra_ds is not None:
        ds = ds + extra_ds
    ds = torch.where(live, ds, 0.0)
    s = torch.where(live, s, ap.MASKED)
    m = s.amax(-1, keepdim=True)
    x = s - m
    e = torch.where(live, ds + ds.amax(-1, keepdim=True) + 2.0 ** -20 * (1 + x.abs() + m.abs()),
                    0.0)
    del s, ds
    P = ap.probabilities(x, form, bf16exp).to(torch.bfloat16).float()
    ends = [ap.probabilities(x + sign * e, form, bf16exp).to(torch.bfloat16).float()
            for sign in (-1, 1)]
    if bf16exp:
        log2e = torch.tensor(av.LOG2E, dtype=torch.float32)
        for sign in (-1, 1):
            arg = ((x + sign * e) * log2e).to(torch.bfloat16)
            p = av.ex2_bf16(arg)
            if ex2_dev is not None:
                p = p * torch.exp(sign * ex2_dev[av.bf16_bits(arg)])
            ends.append(p)
    lo = torch.stack(ends[0::2]).amin(0)
    hi = torch.stack(ends[1::2]).amax(0)
    del ends
    dP = torch.where(live, torch.maximum(hi - lo, torch.maximum(hi - P, P - lo)), 0.0)
    del lo, hi
    if form == "std":
        p = torch.exp(x)
        l = p.sum(-1, keepdim=True)
        dl = (p * torch.expm1(e)).sum(-1, keepdim=True) / l + nv * 2.0 ** -22
        del p
    else:
        l = P.sum(-1, keepdim=True)
        r = dP.sum(-1, keepdim=True) / l
        dl = r + nv * 2.0 ** -22 * (1 + r)
    del x, e
    va = vh.abs()
    o = (P @ vh).abs() / l
    dv = (dP @ va + nv * 2.0 ** -22 * ((P + dP) @ va)) / (l * (1 - dl)) \
        + o * dl / (1 - dl) + 2.0 ** -21 * o
    return dv + ulp(want.float().abs() + dv)


def pvt_heads(t):
    """A pvt operand or output, (B, H, N, 64) or (B, G, 2, N, 64), as
    head-major (B, H, N, 64)."""
    return t if t.dim() == 4 else t.reshape(t.shape[0], -1, *t.shape[-2:])


def pvt_check(torch, ap, case, q, k, v, nv, tables, got, ex2_dev=None) -> dict:
    """``got`` against the plain version within :func:`pvt_tolerance`, in
    chunks of images whose fp32 scores fit in 512 MiB."""
    q, k, v, got = (pvt_heads(t) for t in (q, k, v, got))
    B, H, N, _ = q.shape
    chunk = max(1, 2 ** 29 // (4 * H * N * N))
    err, worst, ok = 0.0, 0.0, bool(torch.isfinite(got).all())
    for b0 in range(0, B, chunk):
        part = [t[b0:b0 + chunk] for t in (q, k, v)]
        want = ap.attention_pvt_reference(*part, nv, tables, form=case["form"],
                                          bf16exp=case["bf16exp"])
        tol = pvt_tolerance(torch, ap, *part, nv, tables, want, case["form"], case["bf16exp"],
                            ex2_dev=ex2_dev)
        e = (got[b0:b0 + chunk].float() - want.float()).abs()
        err, worst = max(err, float(e.max())), max(worst, float((e / tol).max()))
        ok = ok and bool((e <= tol).all())
        del want, tol, e
    return {"max_abs_err": err, "max_err_over_tol": worst,
            "tol": "pvt_tolerance (chip_smoke.py)", "ok": ok}


def pvt_inputs(torch, device="cuda") -> dict:
    """The probes' operands at PVT_SHAPE, drawn on ``device`` from a seeded
    generator: "blocks", the (B, G, N, 128) q, k, v (dead k and v rows NaN);
    "q", "k", "v", their (B, G, 2, N, 64) head-pair views; "cos", "sin"; the
    kernel's "tables"."""
    from cbas_tpu_torch.ops import attention_batched as ab

    B, H, N, nv = PVT_SHAPE
    d = 64
    gen = torch.Generator(device).manual_seed(SEED + 16)
    blocks = [(torch.randn(B, H // 2, N, 2 * d, generator=gen, device=device)
               * BATCHED_INPUT_SCALE).to(torch.bfloat16) for _ in range(3)]
    for t in blocks[1:]:
        t[:, :, nv:] = float("nan")
    cos, sin = (torch.randn(N, d, generator=gen, device=device) for _ in range(2))
    views = [t.view(B, H // 2, N, 2, d).transpose(2, 3) for t in blocks]
    return {"blocks": blocks, "q": views[0], "k": views[1], "v": views[2], "cos": cos,
            "sin": sin, "tables": ab.rope_tables(cos, sin, d ** -0.5, d ** 0.5)}


def pvt_call(ap, case, inputs, items=None):
    """The kernel call of a PVT_CASES case on the probes' views."""
    nv = PVT_SHAPE[3]
    return lambda: ap.attention_pvt(inputs["q"], inputs["k"], inputs["v"], nv, inputs["tables"],
                                    form=case["form"], bf16exp=case["bf16exp"],
                                    items=items or 2 * case["gp"])


def pvt_case(torch, fa, ap, case, inputs, device="cuda", ex2_dev=None) -> dict:
    """One PVT_CASES case: the kernel against its plain version
    (:func:`pvt_check`), then, on the card, timed between two reads of K2 on
    the same blocks with RoPE (the probes' ``prod``: K2, kernel, kernel, K2)
    beside its bound, the blocks and waves it runs in on the card's SMs, the
    same call at a block count that fills the card in one wave, the plain
    version over the chunks, the SM clock sampled around it, and the max abs
    difference from K2's output (the probes' printed error; information, not a
    check)."""
    B, H, N, nv = PVT_SHAPE
    d, on_card = 64, device == "cuda"
    items = 2 * case["gp"]
    out = {"phase": "pvt", "what": case["what"], "body": case["body"], "form": case["form"],
           "bf16exp": case["bf16exp"], "option_set": ap.option_set(True, case["form"],
                                                                  case["bf16exp"]),
           "shape": [B, H, N, d], "n_valid": nv, "items": items}
    if on_card:
        out["clocks_before"] = gpu_clocks()
    kernel = pvt_call(ap, case, inputs)
    before = ap.launches
    got = kernel()
    if on_card:
        torch.cuda.synchronize()
    out["launches"] = ap.launches - before
    out.update(pvt_check(torch, ap, case, inputs["q"], inputs["k"], inputs["v"], nv,
                         inputs["tables"], got, ex2_dev))
    out["ok"] = out["ok"] and out["launches"] == int(on_card)
    if on_card:
        scale = d ** -0.5
        cos, sin = inputs["cos"], inputs["sin"]

        def k2():
            return fa.fused_attention_packed(*inputs["blocks"], scale, nv, cos, sin)

        want = k2().view(B, H // 2, N, 2, d).transpose(2, 3)
        out["max_abs_err_vs_k2"] = float((got[..., :nv, :].float()
                                          - want[..., :nv, :].float()).abs().max())
        del want
        reads = [time_ms(torch, f) for f in (k2, kernel, kernel, k2)]
        out.update({"ms": (reads[1] + reads[2]) / 2, "ms_reads": reads[1:3],
                    "k2_ms": (reads[0] + reads[3]) / 2}, **pvt_bound(B * H, N, nv, d))
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        sms = torch.cuda.get_device_properties(got.device).multi_processor_count
        out["blocks"] = -(-B * H // items)
        out["sms"], out["waves"] = sms, -(-out["blocks"] // sms)
        out["items_one_wave"] = -(-B * H // sms)
        out["ms_one_wave"] = time_ms(torch, pvt_call(ap, case, inputs, out["items_one_wave"]))
        q, k, v = (pvt_heads(inputs[t]) for t in ("q", "k", "v"))
        chunk = max(1, 2 ** 29 // (4 * H * N * N))

        def plain():
            for b0 in range(0, B, chunk):
                ap.attention_pvt_reference(q[b0:b0 + chunk], k[b0:b0 + chunk], v[b0:b0 + chunk],
                                           nv, inputs["tables"], form=case["form"],
                                           bf16exp=case["bf16exp"])

        out["plain_ms"] = time_ms(torch, plain, iters=1, warmup=0)
        out["ptxas"] = PTXAS.get(PVT_KERNEL, {}).get(pvt_label(case["form"], case["bf16exp"]),
                                                     "not in the build log")
        out["clocks_after"] = gpu_clocks()
    return out


def pvt_label(form, bf16exp) -> str:
    """A pvt kernel instantiation's name in :func:`ptxas_report`."""
    from cbas_tpu_torch.ops.attention_pvt import option_set

    return f"pvt<{option_set(True, form, bf16exp)}>"


def pvt_library(torch, fa, inputs) -> dict:
    """The library call beside every pvt case (the same inputs): SDPA on
    head-major contiguous copies with the key mask, RoPE applied beforehand
    in fp32 and the scale passed in; the memory floor at the cases' bytes.
    The port never calls SDPA."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    B, H, N, nv = PVT_SHAPE
    cos, sin = inputs["cos"], inputs["sin"]
    q, k, v = (pvt_heads(inputs[t]).contiguous() for t in ("q", "k", "v"))
    q, k = ((t.float() * cos + fa.rotate_half(t.float()) * sin).to(t.dtype) for t in (q, k))
    mask = (torch.arange(N, device=q.device) < nv)[None, None, None, :]
    ms = time_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask, scale=64 ** -0.5))
    return {"library_ms": ms, "library": "scaled_dot_product_attention, key mask",
            "floor_ms": floor_ms(torch, B * H * N * 64, "bfloat16")}


def pvt_model_call(torch, fa, ap, model="dinov3-vitb16", batch=320) -> dict:
    """probe23's call alone, as :func:`pvt_attention` makes it in the model
    A/B: the std form at gb 1 (one image's heads a block) on head-major views
    of one fused (B, N, 3*H*64) bf16 projection at 640x480 (N 1205, every
    key live) with the model's tables; against its plain version
    (:func:`pvt_check`), timed between two reads of K3 on the same views
    and tables (K3, kernel, kernel, K3), beside its bound, the memory floor at
    its bytes and SDPA (RoPE applied beforehand)."""
    from cbas_tpu_torch.models.vit import PRESETS
    from cbas_tpu_torch.ops import attention_batched as ab

    cfg = PRESETS[model]
    H, d = cfg.num_heads, cfg.head_dim
    N = cfg.num_prefix_tokens + 30 * 40
    gen = torch.Generator("cuda").manual_seed(SEED + 18)
    qkv = torch.randn(batch, N, 3 * H * d, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(batch, N, H, d).transpose(1, 2)
               for j in range(3))
    cos, sin = rope_full(torch, cfg, d, (30, 40), N, "cuda")
    tables = ab.rope_tables(cos, sin, d ** -0.5, d ** 0.5)
    kernel = lambda: ap.attention_pvt(q, k, v, None, tables, items=H)  # noqa: E731
    k3 = lambda: fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin)  # noqa: E731
    before = ap.launches
    got = kernel()
    torch.cuda.synchronize()
    out = {"phase": "pvt_model_call", "what": "probe23 make_fat_kernel's kernel, the call alone",
           "model": model, "shape": [batch, H, N, d], "items": H, "launches": ap.launches - before,
           **pvt_check(torch, ap, {"form": "std", "bf16exp": False}, q, k, v, N, tables, got)}
    out["max_abs_err_vs_k3"] = float((got.float() - k3().float()).abs().max())
    reads = [time_ms(torch, f) for f in (k3, kernel, kernel, k3)]
    out.update({"ms": (reads[1] + reads[2]) / 2, "ms_reads": reads[1:3],
                "k3_ms": (reads[0] + reads[3]) / 2, **pvt_bound(batch * H, N, N, d),
                "floor_ms": floor_ms(torch, batch * N * H * d, "bfloat16")})
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["library_ms"], kernels = library_case(torch, fa, q, k, v, d ** -0.5, cos, sin)
    out["library"] = f"scaled_dot_product_attention ({sdpa_backend(kernels)})"
    out["ok"] = out["ok"] and out["launches"] == 1
    return out


def pvt_rounds(torch, fa, ap, inputs) -> dict:
    """probe6: PVT_ROUNDS interleaved rounds of K2 and the std form at gp 8
    (PVT_ROUND_CALLS timed calls each after one warm-up), each round's
    ratio pvt / K2, and the medians."""
    B, H, N, nv = PVT_SHAPE
    scale = 64 ** -0.5
    kernel = pvt_call(ap, next(c for c in PVT_CASES if c["what"] == PVT_HEADLINE), inputs)

    def k2():
        return fa.fused_attention_packed(*inputs["blocks"], scale, nv, inputs["cos"],
                                         inputs["sin"])

    k2_ms, pvt_ms = [], []
    for _ in range(PVT_ROUNDS):
        k2_ms.append(time_ms(torch, k2, iters=PVT_ROUND_CALLS, warmup=1))
        pvt_ms.append(time_ms(torch, kernel, iters=PVT_ROUND_CALLS, warmup=1))
    ratios = [b / a for a, b in zip(k2_ms, pvt_ms)]
    return {"phase": "pvt_rounds", "what": "probe6 pvt_kernel gp 8 against K2",
            "body": "probe6_pvt_interleaved.py:20", "rounds": PVT_ROUNDS,
            "k2_ms": k2_ms, "pvt_ms": pvt_ms, "ratios": ratios,
            "median_ratio": float(np.median(ratios)), "median_k2_ms": float(np.median(k2_ms)),
            "median_pvt_ms": float(np.median(pvt_ms))}


def pvt_attention(params, prefix, x, cfg, rope):
    """probe23's fat_attention on the port's model: ``vit._attention`` with
    its one q|k|v projection GEMM, the head-major views of its output handed to
    the streamed transposed-score kernel (form std) with probe23's tables (q's
    times the scale, k's times the scale times sqrt(d)), one image's heads a
    block (probe23's gb 1), the context back through the out-projection.
    Swapped in by :func:`pvt_model_case` only: no route of the package calls
    it."""
    import torch.nn.functional as F

    from cbas_tpu_torch.models import vit
    from cbas_tpu_torch.ops import attention_batched as ab
    from cbas_tpu_torch.ops import attention_pvt as ap

    B, N, _ = x.shape
    hd = cfg.head_dim
    _, _, out_name, out_bias = vit._attn_param_table(cfg, prefix)
    weight, bias = vit._fused_qkv(params, prefix)
    HD = weight.shape[0] // 3
    qkv = F.linear(x, weight, bias)
    vit._count_gemm("qkv")
    q, k, v = (qkv[..., j * HD:(j + 1) * HD].view(B, N, HD // hd, hd).transpose(1, 2)
               for j in range(3))
    tables = ab.rope_tables(*rope, hd ** -0.5, hd ** 0.5)
    ctx = ap.attention_pvt(q, k, v, None, tables, items=HD // hd)
    return vit._dense_reduce(params, out_name, ctx.transpose(1, 2).reshape(B, N, HD), out_bias,
                             cfg.hidden_size)


def pvt_model_case(torch, enc, planes, batch, device="cuda", reps=PVT_MODEL_REPS) -> dict:
    """probe23's model A/B: ``enc`` over ``planes`` through the port's
    ``_attention`` (K1 on fused views) and with :func:`pvt_attention` swapped
    in, in one process: the embeddings' cosine against K1's, the std form's
    launches a forward (one a full block: L - 1) and no other option set's,
    and on the card warm frames/s in PVT_MODEL_READS' order."""
    from cbas_tpu_torch.ops import attention_pvt as ap

    k1 = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
    before = dict(ap.launches_by_option)
    with swapped_attention(pvt_attention):
        got = enc.encode_planes(planes[:batch], batch=batch).astype(np.float32)
    launches = {o: n - before.get(o, 0) for o, n in ap.launches_by_option.items()
                if n != before.get(o, 0)}
    option = ap.option_set(True, "std", False)
    expected = (enc.cfg.num_layers - 1) * int(device == "cuda")
    out = {"phase": "pvt_model", "what": "probe23 model A/B", "encoder": enc.identifier,
           "geometry": list(planes.shape[1:]), "batch": batch, "option_set": option,
           "launches_a_forward": launches.get(option, 0),
           "other_launches": {o: n for o, n in launches.items() if o != option},
           "expected_launches_a_forward": expected,
           "min_cos_vs_k1": float(row_cosine(k1, got).min()), "tol_min_cos": BATCHED_MODEL_MIN_COS,
           "finite": bool(np.isfinite(got).all())}
    out["ok"] = out["finite"] and out["min_cos_vs_k1"] >= BATCHED_MODEL_MIN_COS \
        and out["launches_a_forward"] == expected and not out["other_launches"]
    if device == "cuda":
        reads = []
        for route in PVT_MODEL_READS:
            with (swapped_attention(pvt_attention) if route == "pvt"
                  else contextlib.nullcontext()):
                reads.append(warm_fps(torch, enc, planes, batch, reps))
        out["fps_reads"] = {"order": list(PVT_MODEL_READS), "fps": reads, "reps": reps}
        out["fps"] = {route: sum(f for r, f in zip(PVT_MODEL_READS, reads) if r == route) / 2
                      for route in dict.fromkeys(PVT_MODEL_READS)}
    return out


def pvt_phase(torch, models=PVT_MODELS, geometry=(480, 640), device="cuda") -> dict:
    """Every PVT_CASES case (:func:`pvt_case`) on one set of the probes'
    inputs, probe6's rounds (:func:`pvt_rounds`) and probe23's model A/B
    (:func:`pvt_model_case`) for each of ``models`` ((preset or ViTConfig,
    batch)) at ``geometry``, the kernel's launch counts set to 0 before and
    read after: {"cases", "library", "rounds", "models", "launches",
    "seconds"}. A failed check, or an option set of BUILT never launched on
    the card, raises. (``device`` is "cpu" only in the CPU test, where the
    shape and the models are cut: the plain versions on both sides,
    untimed.)"""
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import PRESETS
    from cbas_tpu_torch.ops import attention_pvt as ap
    from cbas_tpu_torch.ops import attention_variants as av
    from cbas_tpu_torch.ops import flash_attention as fa

    on_card = device == "cuda"
    t = time.perf_counter()
    ap.launches = 0
    ap.launches_by_option.clear()
    ex2_dev = ex2_deviation(torch, av)[0] if on_card else None
    inputs = pvt_inputs(torch, device)
    cases = []
    for case in PVT_CASES:
        cases.append(pvt_case(torch, fa, ap, case, inputs, device, ex2_dev))
        emit(cases[-1])
    library = rounds = model_call = None
    if on_card:
        library = pvt_library(torch, fa, inputs)
        rounds = pvt_rounds(torch, fa, ap, inputs)
        emit({"phase": "pvt_library", **library})
        emit(rounds)
    del inputs
    if on_card:
        model_call = pvt_model_call(torch, fa, ap)
        emit(model_call)
    model_lines = []
    for model, batch in models:
        cfg = PRESETS[model] if isinstance(model, str) else model
        name = model if isinstance(model, str) else ENCODER
        enc = FrameEncoder(name, cfg=cfg, random_init=True, device=device)
        planes = np.random.default_rng(SEED).integers(0, 256, (batch, *geometry), np.uint8)
        model_lines.append(pvt_model_case(torch, enc, planes, batch, device))
        emit(model_lines[-1])
        del enc
    out = {"cases": cases, "library": library, "rounds": rounds, "models": model_lines,
           "model_call": model_call, "launches": dict(ap.launches_by_option),
           "seconds": time.perf_counter() - t}
    emit({"phase": "pvt_summary", "seconds": out["seconds"], "launches": out["launches"],
          "ms": [{"what": c["what"], **{key: c.get(key) for key in (
              "ms", "ms_one_wave", "k2_ms", "bound_ms", "plain_ms", "waves")}} for c in cases],
          "median_ratio_vs_k2": rounds["median_ratio"] if rounds else None,
          "model_fps": [m.get("fps") for m in model_lines]})
    bad = [c for c in cases + model_lines + [model_call or {"ok": True}] if not c["ok"]]
    if bad:
        raise AssertionError(f"a pvt case disagrees with its yardstick: {bad}")
    unlaunched = sorted(ap.option_set(*o) for o in ap.BUILT
                        if ap.option_set(*o) not in out["launches"])
    if on_card and unlaunched:
        raise AssertionError(f"the pvt phase launched {out['launches']} (never: {unlaunched})")
    return out


def pvt_kernel_entry(pvt) -> dict:
    """The ``kernels`` line's entry of the streamed transposed-score kernel:
    its launches over the pvt phase by option set, the headline case's
    numbers (PVT_HEADLINE), every case's, probe6's rounds and the model
    A/Bs."""
    case = next(c for c in pvt["cases"] if c["what"] == PVT_HEADLINE)
    keys = ("max_abs_err", "max_err_over_tol", "ms", "k2_ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "blocks", "waves", "items_one_wave", "ms_one_wave",
            "max_abs_err_vs_k2")
    return {
        "name": PVT_KERNEL, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{PVT_KERNEL}.cu",
        "replaces": PVT_REPLACES, "sites": list(PVT_SITES),
        "launches": sum(pvt["launches"].values()), "launches_by_option": pvt["launches"],
        "what": case["what"], "shape": case["shape"], "n_valid": case["n_valid"],
        "items": case["items"], **{key: case[key] for key in keys},
        **pvt["library"], "ptxas": case["ptxas"],
        "cases": [{key: c.get(key) for key in ("what", "body", "option_set", "items") + keys}
                  for c in pvt["cases"]],
        "rounds": pvt["rounds"], "models": pvt["models"], "model_call": pvt["model_call"],
        "seconds": pvt["seconds"],
        "ptxas_all": list(PTXAS.get(PVT_KERNEL, {}).items()),
    }


def ln_tolerance(torch, x, want, w, b, two_pass: bool, bits: int):
    """LN_STAT_REL's bound on |y - want|, elementwise, for the LayerNorm
    ``want`` (fp32 values of the output dtype, ``bits`` significant bits)
    of the rows ``x`` with the affine ``w``, ``b``: one ulp of the output
    plus 2^-17 kappa (|want - b| + |w| rstd mean|x|), kappa = E[x^2] / var
    for the single-pass variance and 1 for two-pass."""
    var = x.var(-1, keepdim=True, unbiased=False)
    kappa = 1.0 if two_pass else ((x * x).mean(-1, keepdim=True) / (var + LN_EPS)).clamp_min(1.0)
    terms = (want - b).abs() + w.abs() * torch.rsqrt(var + LN_EPS) * x.abs().mean(-1, keepdim=True)
    return dtype_ulp(torch, want, bits) + LN_STAT_REL * kappa * terms, kappa


def ln_config(dtype: str, D: int, vec: bool) -> str:
    """The kernel ``csrc/layernorm.cu`` dispatches to for ``dtype`` and
    ``D`` (``vec``: on its 16-byte path), named as :func:`ptxas_report`
    names it, with the warps it gives a row."""
    V = (8 if dtype == "bfloat16" else 4) if vec else 1
    chunks, warps = -(-D // V), 1
    while warps < 8 and chunks > 32 * warps * 4:
        warps *= 2
    c = -(-chunks // (32 * warps))
    short = "bf16" if dtype == "bfloat16" else "f32"
    if c > 8:
        return f"ln_stream<{short}>, 32 warps a row"
    return f"ln_rows<{short}, V{V}, C{c}>, {warps} warp{'s' if warps > 1 else ''} a row"


def outlier_rows(rng, rows, D):
    """``tools/validate_kernels.py``'s LayerNorm rows, a quarter each: unit
    noise; unit noise with 4 dims at +-1000 (sparse massive activations);
    +30 and -100 offsets with unit noise (near-constant rows, where the
    single-pass variance cancels)."""
    q = rows // 4
    x = rng.standard_normal((rows, D)).astype(np.float32)
    for i in range(q, 2 * q):
        x[i, rng.integers(0, D, 4)] = 1000.0 * (1 - 2 * (i % 2))
    x[2 * q:3 * q] += 30.0
    x[3 * q:] -= 100.0
    return x


def ln_case(torch, ln, rows, D, dtype, residual=True, two_pass=None, outliers=False,
            cls_rows=False, affine_f32=False, time_it=False, what="", device="cuda"):
    """The LayerNorm kernel on the card against its plain version on the
    same inputs: x (``outliers``: :func:`outlier_rows`) and h unit normal,
    lambda in [0.1, 1], w in [0.5, 1.5], b of std 0.1, from a numpy seed, in
    ``dtype`` (the affine in fp32 with ``affine_f32``). ``cls_rows``: x is
    the CLS rows ``x[:, :1]`` of a (rows, 261, D) stream, read in place
    through its row stride. The residual stream bit for bit, y within
    LN_STAT_REL's tolerance; with ``time_it``, timed beside the plain
    version, the library call and the bound. (``device`` is "cpu" only in
    the CPU test of this function: the plain version on both sides,
    untimed.)"""
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(SEED + rows + D)
    x_np = outlier_rows(rng, rows, D) if outliers else rng.standard_normal((rows, D), np.float32)
    h = torch.from_numpy(rng.standard_normal((rows, D), np.float32)).to(device, dt)
    pdt = torch.float32 if affine_f32 else dt
    lam, w, b = (torch.from_numpy(a.astype(np.float32)).to(device, pdt) for a in (
        rng.uniform(0.1, 1.0, D), rng.uniform(0.5, 1.5, D), 0.1 * rng.standard_normal(D)))
    if cls_rows:
        stream = torch.from_numpy(rng.standard_normal((rows, 261, D), np.float32)).to(device, dt)
        stream[:, 0] = torch.from_numpy(x_np).to(device, dt)
        x, h = stream[:, :1], h[:, None]
    else:
        x = torch.from_numpy(x_np).to(device, dt)
    del x_np
    if residual:
        kernel = lambda: ln.add_layernorm(x, h, lam, w, b, LN_EPS, two_pass)  # noqa: E731
        plain = lambda: ln.add_layernorm_reference(x, h, lam, w, b, LN_EPS, two_pass)  # noqa: E731
        library = lambda: F.layer_norm(x + h * lam, (D,), w, b, LN_EPS)  # noqa: E731
    else:
        kernel = lambda: (None, ln.layernorm(x, w, b, LN_EPS, two_pass))  # noqa: E731
        plain = lambda: (x, ln.layernorm_reference(x, w, b, LN_EPS, two_pass))  # noqa: E731
        library = lambda: F.layer_norm(x, (D,), w, b, LN_EPS)  # noqa: E731
    before = ln.launches
    x_got, y = kernel()
    x_new, want = plain()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    two = ln.use_two_pass(dt, two_pass)
    want32 = want.float()
    tol, kappa = ln_tolerance(torch, x_new.float(), want32, w.float(), b.float(), two,
                              8 if dtype == "bfloat16" else 24)
    err = (y.float() - want32).abs()
    bit_equal = None if not residual else bool(torch.equal(x_got, x_new))
    vec = (D % (8 if dtype == "bfloat16" else 4) == 0)
    out = {
        "phase": "kernel_layernorm", "what": what, "rows": rows, "D": D, "dtype": dtype,
        "residual": residual, "two_pass": two, "outlier_rows": outliers,
        "x": f"x[:, :1] of ({rows}, 261, {D})" if cls_rows else "contiguous",
        "affine_dtype": str(pdt).replace("torch.", ""),
        "launches": ln.launches - before, "residual_bit_equal": bit_equal,
        "max_abs_err": float(err.max()), "max_err_over_tol": float((err / tol).max()),
        "tol": f"1 {dtype} ulp + 2^-17 kappa (|y - b| + |w| rstd mean|x'|)",
        "max_kappa": kappa if two else float(kappa.max()),
        "kernel": ln_config(dtype, D, vec),
    }
    out["ptxas"] = PTXAS.get(LN_KERNEL, {}).get(out["kernel"].split(">, ")[0] + ">",
                                                "not in the build log")
    out["ok"] = bool(torch.isfinite(y).all()) and bool((err <= tol).all()) \
        and bit_equal is not False and out["launches"] == int(on_card) and y.shape == x.shape \
        and y.is_contiguous()
    if time_it and on_card:
        size = torch.finfo(dt).bits // 8
        nbytes = size * rows * D * (4 if residual else 2) \
            + D * sum(t.element_size() for t in ((lam, w, b) if residual else (w, b)))
        out["ms"] = time_ms(torch, kernel)
        out["plain_ms"] = time_ms(torch, plain)
        out["library_ms"] = time_ms(torch, library)
        out["library"] = ("x + h * lam, then F.layer_norm" if residual else "F.layer_norm")
        out["mbytes"] = nbytes / 1e6
        out["bound_ms"] = 1e3 * nbytes / PEAK_BYTES_PER_S
        out["bound_by"] = "bytes"
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
        # the floor at the rows' bytes: four tensors of rows x D (fused), or
        # of half that (the LayerNorm alone reads x and writes y)
        out["floor_ms"] = floor_ms(torch, rows * D // (1 if residual else 2), dtype)
    return out


def ln_kernel_phase(torch, device="cuda") -> dict:
    """The LayerNorm kernel's cases (phase 2), each timed: at each of
    LN_MAIN_SHAPES the main paths' form (bf16, fused, single-pass); at the
    first also block 0's LayerNorm alone, the two-pass form, fp32 and the
    CLS rows in place; the outlier rows in every mode; fp32 affine with
    bf16 x; and LN_SMALL_SHAPES. Returns {"main": the main-shape cases, "other": the
    first shape's other timed cases}. (``device`` is "cpu" only in the CPU
    test of this function.)"""
    from cbas_tpu_torch.ops import layernorm as ln

    def case(*args, **kw):
        return ln_case(torch, ln, *args, time_it=True, device=device, **kw)

    main = [case(rows, D, "bfloat16", what="main path: fused, single-pass")
            for rows, D in LN_MAIN_SHAPES]
    rows, D = LN_MAIN_SHAPES[0]
    other = [
        case(rows, D, "bfloat16", residual=False, what="block 0's norm1: LayerNorm alone"),
        case(rows, D, "bfloat16", two_pass=True, what="fused, two-pass (CBAS_LN_TWO_PASS)"),
        case(rows, D, "float32", what="fused, fp32 (runtime.compute_dtype: float32)"),
        case(BATCH_256, D, "bfloat16", cls_rows=True,
             what="the last block's norm2: CLS rows read in place"),
    ]
    cases = main + other
    for dtype, two_pass in (("bfloat16", False), ("bfloat16", True), ("float32", None)):
        for residual in (True, False):
            cases.append(case(64, 768, dtype, residual, two_pass, outliers=True,
                              what="outlier rows"))
    cases.append(case(64, 768, "bfloat16", outliers=True, affine_f32=True,
                      what="fp32 affine on bf16 x (tools/validate_kernels.py)"))
    for rows, D, what in LN_SMALL_SHAPES:
        for dtype, two_pass, residual in (("bfloat16", None, True), ("bfloat16", True, False),
                                          ("float32", None, True)):
            cases.append(case(rows, D, dtype, residual, two_pass, what=what))
    for c in cases:
        emit(c)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"the LayerNorm kernel disagrees with its plain version: {bad}")
    return {"main": main, "other": other}


def reset_launches(fa) -> None:
    from cbas_tpu_torch.models import vit
    from cbas_tpu_torch.ops import layernorm as ln

    fa.launches = fa.launches_packed = fa.launches_headmajor = fa.launches_sm90 = 0
    fa.launches_wide = fa.launches_sm90_f32 = fa.launches_tf32_prologue = 0
    fa.launches_sm90_f32_wide = fa.launches_sm90_f32_slices = fa.launches_stage = 0
    fa.launches_sm90_ws = 0
    fa.launches_headmajor_by_dim.clear()
    fa.launches_sm90_by_kernel.clear()
    fa.launches_sm90_f32_by_kernel.clear()
    ln.launches = 0
    for kind in vit.projection_gemms:
        vit.projection_gemms[kind] = 0


def read_launches(fa) -> dict:
    """Launches of each entry, under "sm90" those that ran the Hopper body
    (by entry under "sm90_by_kernel"), under "sm90_f32" those that ran its
    fp32 counterpart (by entry under "sm90_f32_by_kernel"), under
    "sm90_f32_wide" K3's that ran its wide form, under "sm90_f32_slices"
    K3's that ran its slices body, under "tf32_prologue" their prologue,
    under "wide" K3's that ran the (bf16) wide body, under "sm90_ws" K3's
    that ran the two-consumer body, under "staging" bf16's
    staging pass, under "headmajor_by_dim" K3's split by the head dim it ran at,
    under "layernorm" the LayerNorm kernel's, and under "projection_gemms"
    the attention's projection GEMMs as ``models/vit.py`` counts them (a
    full block's fused q|k|v, the CLS block's q and k|v; counted on every
    device)."""
    from cbas_tpu_torch.models import vit
    from cbas_tpu_torch.ops import layernorm as ln

    return {"attention_fat": fa.launches, "attention_packed": fa.launches_packed,
            "attention_headmajor": fa.launches_headmajor, "sm90": fa.launches_sm90,
            "sm90_f32": fa.launches_sm90_f32, "sm90_f32_wide": fa.launches_sm90_f32_wide,
            "sm90_f32_slices": fa.launches_sm90_f32_slices,
            "tf32_prologue": fa.launches_tf32_prologue, "wide": fa.launches_wide,
            "sm90_ws": fa.launches_sm90_ws, "staging": fa.launches_stage,
            "sm90_by_kernel": dict(fa.launches_sm90_by_kernel),
            "sm90_f32_by_kernel": dict(fa.launches_sm90_f32_by_kernel),
            "headmajor_by_dim": dict(fa.launches_headmajor_by_dim),
            LN_KERNEL: ln.launches, "projection_gemms": dict(vit.projection_gemms)}


def ln_per_forward(num_layers: int) -> int:
    """The LayerNorm kernel's launches in one cls-only forward of
    ``num_layers`` blocks: block 0's norm1, then each block's norm2 and the
    next norm1 (the last block: norm2 and the final LayerNorm)."""
    return 2 * num_layers + 1


def projections_per_run(full_blocks: int, cls_blocks: int) -> dict:
    """The projection GEMMs of ``full_blocks`` full blocks and ``cls_blocks``
    CLS-only blocks: one fused q|k|v GEMM a full block, and a CLS block's q
    on the CLS row and one k|v GEMM over every token (three GEMMs a block
    each before the projections were fused)."""
    return {"qkv": full_blocks, "q_cls": cls_blocks, "kv_cls": cls_blocks}


def check_launches(route, got, kernel, per_forward, forwards, sm90, ln_per,
                   cls_blocks=None, sm90_f32=False) -> dict:
    """The route launched ``kernel`` ``per_forward`` times a forward, and no
    other attention kernel; each launch through the Hopper body if ``sm90``,
    else none; each through the fp32 Hopper body, with one launch of its
    prologue, if ``sm90_f32``, else none; the LayerNorm kernel ``ln_per``
    times a forward; and one projection GEMM a full block (``per_forward`` a
    forward) and one k|v GEMM a CLS block (``cls_blocks``, one a forward
    unless given)."""
    want = {name: 0 for name in KERNELS}
    want[kernel] = per_forward * forwards
    want["sm90"] = want[kernel] if sm90 else 0
    want["sm90_f32"] = want["tf32_prologue"] = want[kernel] if sm90_f32 else 0
    want["sm90_f32_wide"] = want["sm90_f32_slices"] = want["sm90_ws"] = 0
    want[LN_KERNEL] = ln_per * forwards
    want["projection_gemms"] = projections_per_run(
        per_forward * forwards, forwards if cls_blocks is None else cls_blocks)
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


FP32_TRACE_FLAG = "--fp32-trace"  # chip_smoke.py run as fp32_trace's own process


def fp32_trace() -> dict:
    """A ``torch.profiler`` trace of one warm fp32 dinov3-vitb16 batch
    (``runtime.compute_dtype: float32``, the flat route) at 256x256 (batch
    128) and 640x480 (batch 32), its kernels summed by ``chip_ab.py``'s
    KERNEL_GROUPS, in a process of its own (this script with
    FP32_TRACE_FLAG): a fresh process's trace holds its device events."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), FP32_TRACE_FLAG],
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise AssertionError(f"the fp32 trace's process failed ({proc.returncode}): "
                             f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def fp32_trace_main() -> int:
    """FP32_TRACE_FLAG's run: the traces of :func:`fp32_trace`, printed as
    one JSON line."""
    import torch

    import chip_ab
    from cbas_tpu_torch.models.encoder import FrameEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    enc = FrameEncoder(ENCODER, random_init=True, compute_dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(SEED)
    out = {"phase": "fp32_trace", "encoder": ENCODER, "dtype": "float32", "route": "flat (K1)",
           "card": card_name_and_power()}
    for label, shape, batch in (("256x256", (256, 256), BATCH_256), ("640x480", (480, 640), BATCH_480)):
        planes = rng.integers(0, 256, (batch, *shape), np.uint8)
        out[label] = {"batch": batch, **chip_ab.trace_groups(chip_ab.trace_calls(
            torch, lambda planes=planes, batch=batch: enc.encode_planes_async(planes, batch=batch),
            calls=3))}
    print(json.dumps(out), flush=True)
    return 0


def tf32_kernel_entries(main_cases, tf32, fp32_runs, tools_line) -> list:
    """The ``kernels`` line's entries of the fp32 Hopper body
    (``attention_sm90_tf32.cuh``) and of its prologue (split_kv): their
    launches on the fp32 flat route's forward (and on every fp32 route and
    in validate_kernels), the body's numbers at K1's 256x256 shape with RoPE
    beside every fp32 main-shape case, the prologue's at
    the same shape beside its other cases."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "gflop", "mbytes", "share_of_bound", "floor_ms", "ptxas")
    cases = main_cases["fp32"]
    main = next(c for c in cases if c["name"] == "attention_fat" and c["N"] == 261)
    if any(c["body"] != "sm90_f32" for c in cases):
        raise AssertionError(f"an fp32 main-shape case ran another body: {cases}")
    prologue = next(c for c in tf32["prologue"] if c["shape"][:3] == [BATCH_256, 261, 12]
                    and c["rope"])
    validate = tools_line["validate_kernels"]
    return [{
        "name": "attention_sm90_tf32", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_sm90_tf32.cuh",
        "replaces": KERNELS["attention_fat"],
        "serves": [KERNELS[name] for name in KERNELS], "body": "sm90_f32",
        "launches": fp32_runs["attention_fat"]["sm90_f32"],
        "launches_by_route": {name: run["sm90_f32"] for name, run in fp32_runs.items()},
        "launches_validate_kernels": validate["expected_launches"]["sm90_f32"],
        **{key: main[key] for key in keys},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")], "inputs": main["inputs"],
        "cases": [{key: c[key] for key in keys}
                  | {key: c[key] for key in ("name", "inputs", "B", "N", "H", "head_dim")}
                  for c in cases],
        "validate_kernels_max_f32_err": validate["max_f32_err"],
    }, {
        "name": "split_kv", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_sm90_tf32.cuh",
        "replaces": KERNELS["attention_fat"],
        "what": "the fp32 body's prologue: K's RoPE (in _fat_kernel's body on the TPU), K and V "
                "split into TF32 pairs, V transposed, once a call",
        "launches": fp32_runs["attention_fat"]["tf32_prologue"],
        "launches_by_route": {name: run["tf32_prologue"] for name, run in fp32_runs.items()},
        "launches_phase": tf32["launches"]["tf32_prologue"],
        "max_abs_err": prologue["max_abs_diff"], "bit_equal": prologue["bit_equal"],
        **{key: prologue[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "mbytes",
                                          "gbps", "floor_ms", "share_of_bound")},
        "library_ms": None, "library": "none: no PyTorch call splits into TF32 pairs",
        "shape": prologue["shape"], "rope": prologue["rope"],
        "ptxas": [f"{k}: {v}" for k, v in PTXAS.get("attention_fat", {}).items()
                  if k.startswith("split_kv")],
        "cases": [{key: c.get(key) for key in ("shape", "n_valid", "rope", "bit_equal", "ms",
                                                "plain_ms", "bound_ms", "gbps", "floor_ms")}
                  for c in tf32["prologue"]],
    }]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run.", file=sys.stderr)
        return 2
    if FP32_TRACE_FLAG in sys.argv[1:]:
        return fp32_trace_main()
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

    # 2. the memory floor at every timed row's bytes (its own path: the
    # count set to 0 before, read after), then the kernels against their
    # plain versions, each timed row with its floor beside it
    cfg = PRESETS[ENCODER]
    floor = floor_phase(torch)
    main_cases = kernel_phase(torch, fa, cfg)
    persistent = persistent_phase(torch, fa, cfg, main_cases)  # its own path: its entry's count set to 0 before
    tf32 = tf32_phase(torch, fa, cfg)  # its own path: the prologue's counts set to 0 before
    stages = stage_phase(torch, cfg)  # its own path: the variants' counts set to 0 before
    batched = batched_phase(torch, cfg)  # its own path: the two kernels' counts set to 0 before
    pvt = pvt_phase(torch)  # its own path: the kernel's counts set to 0 before
    ln_cases = ln_kernel_phase(torch)

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
    ln_per = ln_per_forward(cfg.num_layers)

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
                               sm90=True, ln_per=ln_per)
    for name, e, n in (("256x256", emb_256, FRAMES_256), ("640x480", emb_480, BATCH_480)):
        if e.shape != (n, cfg.hidden_size) or e.dtype != np.float16 or not np.isfinite(e).all():
            raise AssertionError(f"{name} embeddings: {e.shape} {e.dtype}, finite={np.isfinite(e).all()}")

    emit({
        "phase": "encode", "route": "flat (K1)", "encoder": ENCODER, "dtype": "bfloat16",
        "frames_256": FRAMES_256, "batch_256": BATCH_256, "frames_480": BATCH_480,
        "forwards": forwards, "launches": flat_launches, "expected_launches": want_flat,
        "main_path_s": main_s,
        "kernels_one_forward": len(trace_kernels(torch, lambda: enc.encode_planes_async(
            planes_256[:BATCH_256], batch=BATCH_256))),
        "kernels_one_forward_unfused": UNFUSED_KERNELS_A_FORWARD["vitb16"],
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
    # Warm fp32 frames/s beside bf16's, and the trace of one fp32 batch.
    emit({"phase": "encode_fp32", "route": "flat (K1)", "encoder": ENCODER, "dtype": "float32",
          "body": fa.attention_body("attention_fat", torch.float32, 64),
          "warm_fps_256": warm_fps(torch, gpu32, planes_256, BATCH_256, 3),
          "warm_fps_480": warm_fps(torch, gpu32, planes_480, BATCH_480, 3),
          "batch_256": BATCH_256, "batch_480": BATCH_480, "card": card})
    del cpu, gpu32
    emit(fp32_trace())

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
            "packed", packed_launches, "attention_packed", per_forward, pf_256 + pf_480, sm90=True,
            ln_per=ln_per,
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

    # 6. the ViT-7B-width encode through K3, then the traces of phase 12's
    # forwards (after phases 8 and 9 the profiler records no device events)
    vit7b_launches, vit7b_line, fp32_headmajor = vit7b_phase(torch, fa, FrameEncoder,
                                                             init_vit_params, card)
    wide_traces = wide_heads_traces(torch, fa, FrameEncoder)
    # Launches of one fp32 forward (runtime.compute_dtype: float32) on each
    # route: the same kernel counts as bf16, each through the fp32 Hopper
    # body (with its prologue), none through the bf16 one.
    fp32_runs = {"attention_fat": fp32_flat, "attention_packed": fp32_packed,
                 "attention_headmajor": fp32_headmajor}
    for name, run in fp32_runs.items():
        depth = VIT7B_DEPTH if name == "attention_headmajor" else cfg.num_layers
        check_launches(f"{name} fp32", run, name, depth - 1, 1, sm90=False,
                       ln_per=ln_per_forward(depth), sm90_f32=True)
    fp32_launches = {name: run[name] for name, run in fp32_runs.items()}

    # 7. files end to end, where the host has what the file paths need
    missing = host_missing(("h5py", "pandas", "cv2", "yaml", "matplotlib", "sklearn"))
    if missing:
        emit({"phase": "files", "skipped": f"not installed: {', '.join(missing)}"})
    else:
        emit(files_phase(enc, bundle))

    # 8. head training at full width, then its bundle through the serving path
    train_phase(torch, card, user_tf32, cfg.hidden_size)

    # 9. the app over HTTP on the card, then (9b) the backend as the desktop
    # shell starts and stops it, and (9c) the scripted demo
    app_phase(torch, fa, card)
    shell_phase(card)
    demo_phase(card)

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
    wide_runs, wide_cases, wide_runs32, wide_cases32 = wide_heads_phase(
        torch, fa, FrameEncoder, init_vit_params, card, wide_traces)

    route_launches = {
        "attention_fat": flat_launches, "attention_packed": packed_launches,
        "attention_headmajor": vit7b_launches,
    }
    # K3's launches at each head dim above 128 over the encode runs, phase 12's included
    runs = [*route_launches.values(), *wide_runs.values()]
    wide_launches = {d: sum(run["headmajor_by_dim"].get(d, 0) for run in runs)
                     for d in WIDE_HEAD_DIMS}
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library", "ms_norope", "gflop", "mbytes", "share_of_bound", "floor_ms", "ptxas")
    fused_keys = ("inputs", "max_abs_err", "ms", "ms_norope", "contiguous_ms",
                  "contiguous_ms_norope", "plain_ms", "bound_ms", "bound_by", "floor_ms",
                  "library_ms", "library", "share_of_bound")
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
        "fused_views": [{key: c[key] for key in fused_keys}
                        | {"shape": [c[x] for x in ("B", "N", "H", "head_dim")]}
                        for c in main_cases[f"{name}_fused"]],
        "fp32": [{key: c[key] for key in timing_keys}
                 | {"shape": [c[x] for x in ("B", "N", "H", "head_dim")], "body": c["body"],
                    "inputs": c["inputs"]}
                 for c in main_cases["fp32"] if c["name"] == name],
        "launches_fp32": fp32_launches[name],
        "launches_mesh": mesh_launches[name],
        "launches_tools": {run: launches[name] for run, launches in tools_line["launches"].items()},
    } for name, replaces in KERNELS.items()]
        + [persistent_kernel_entry(persistent),
           ws_kernel_entry(tools_line, wide_runs, wide_cases),
           wide_kernel_entry(tools_line, wide_runs, wide_cases),
           staging_kernel_entry(tools_line, wide_runs, wide_cases),
           ln_kernel_entry(ln_cases, route_launches, fp32_runs, mesh_launches, tools_line,
                           wide_runs),
           *tf32_kernel_entries(main_cases, tf32, fp32_runs, tools_line),
           tf32_wide_kernel_entry(tools_line, wide_runs32, wide_cases32),
           tf32_slices_kernel_entry(tools_line, wide_runs32, wide_cases32),
           floor_kernel_entry(floor), variants_kernel_entry(stages),
           *batched_kernel_entries(batched), pvt_kernel_entry(pvt)]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


COPY_KERNEL = re.compile(r"copy|memcpy", re.IGNORECASE)


TRACE_MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TRACE_TRIES = 6  # traces taken of one call at most, while they hold no event
# Marker kernels that open a trace, and the host's pause after them: a trace
# on the card's machine may lose its first device events (the first two of
# every trace after some hundred card tests in one process), so markers and
# a pause stand in front of the call's own.
TRACE_LEAD, TRACE_LEAD_PAUSE_S = 16, 0.01


def trace_kernels(torch, fn, traces=1) -> list:
    """The names of the CUDA kernels (and copies) one call of ``fn`` ran, in
    the order they started, from a ``torch.profiler`` trace. The trace
    opens with TRACE_LEAD marker kernels (``torch.cuda._sleep``) and a pause
    of the host, the markers left out of the list: on the card's machine a
    trace loses its first device events, which then are the markers', not
    ``fn``'s. It may also lose some
    or every event of ``fn`` (both seen on the card); a lost event is never
    an added one, so the call is traced ``traces`` times and the trace with
    the most events kept, and while the traces hold none, again after a
    pause that grows each time, TRACE_TRIES times in all (every call traced
    here launches a kernel; its callers read their launch counters before
    it). Three empty traces in a row were seen in phase 2."""
    from torch.profiler import ProfilerActivity, profile

    best = []
    for i in range(TRACE_TRIES):
        if i >= traces:
            time.sleep(0.1 * i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(TRACE_LEAD_PAUSE_S)
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and TRACE_MARKER not in e.name]
        if len(events) > len(best):
            best = events
        if best and i + 1 >= traces:
            break
    return [e.name for e in sorted(best, key=lambda e: e.time_range.start)]


def copies_around(kernels, marker, prologues=("rope_rows", "stage_rows")) -> dict:
    """Of a kernel trace: the copy kernels in all, the launches of kernels
    whose name holds ``marker``, and the copy kernels that run next to one
    of them (right before it, past its ``prologues``, or right after it),
    with the names of those neighbours."""
    hits, around, neighbours = 0, 0, set()
    for i, name in enumerate(kernels):
        if marker not in name:
            continue
        hits += 1
        j = i - 1
        while j >= 0 and any(p in kernels[j] for p in prologues):
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
            sm90=True, ln_per=ln_per_forward(cfg.num_layers),
        )
        for name, e, n in (("256x256", emb_256, FRAMES_7B_256), ("640x480", emb_480, BATCH_7B_480)):
            if e.shape != (n, cfg.hidden_size) or e.dtype != np.float16 or not np.isfinite(e).all():
                raise AssertionError(f"ViT-7B {name} embeddings: {e.shape} {e.dtype}")
        # One forward traced: the route hands K3 views of the projections and
        # reads its output back as a view, so no copy kernel runs next to a
        # K3 launch. A trace on the card's machine may lose events (PERF.md
        # §7): one that misses a K3 launch cannot show its neighbours, so it
        # is taken again, TRACE_TRIES times at most.
        for _ in range(TRACE_TRIES):
            copies = copies_around(trace_kernels(torch, lambda: enc.encode_planes_async(
                planes_256[:BATCH_7B_256], batch=BATCH_7B_256)), "attention_sm90")
            if copies["launches"] == cfg.num_layers - 1:
                break
        if copies["launches"] != cfg.num_layers - 1 or copies["copies_around"]:
            raise AssertionError(f"ViT-7B forward: copies next to K3: {copies}")
        copies["kernels_unfused"] = UNFUSED_KERNELS_A_FORWARD["vit7b_depth4"]
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
        del cpu
        emit({"phase": "encode_fp32", "route": "head-major (K3)",
              "model": "ViT-7B width, depth 4", "dtype": "float32",
              "body": fa.attention_body("attention_headmajor", torch.float32, 128),
              "warm_fps_256": warm_fps(torch, gpu32, planes_256, BATCH_7B_256, 3),
              "warm_fps_480": warm_fps(torch, gpu32, planes_480, BATCH_7B_480, 3),
              "batch_256": BATCH_7B_256, "batch_480": BATCH_7B_480, "card": card})
        del gpu32
        torch.cuda.empty_cache()
    return launches, line, fp32_launches


def write_wide_config(ckpt, d) -> int:
    """A checkpoint directory's config.json for phase 12's encoder at
    d-wide heads (WIDE_ENCODER_HEADS of them, WIDE_ENCODER_DEPTH blocks, the
    ViT-7B config's other fields); returns its hidden width."""
    hidden = WIDE_ENCODER_HEADS * d
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump({**VIT7B_CONFIG, "hidden_size": hidden,
                   "num_attention_heads": WIDE_ENCODER_HEADS, "intermediate_size": 2 * hidden,
                   "num_hidden_layers": WIDE_ENCODER_DEPTH}, f)
    return hidden


def wide_heads_planes():
    return np.random.default_rng(SEED + 12).integers(0, 256, (WIDE_ENCODER_FRAMES, 256, 256),
                                                     np.uint8)


def wide_heads_traces(torch, fa, FrameEncoder) -> dict:
    """A profiler trace of one bf16 forward of phase 12's encoder at each of
    WIDE_ENCODER_HEAD_DIMS, taken before phases 8 and 9 (after them the
    profiler's traces on the card's machine hold no device events; phase 12
    reads these): {head dim: :func:`copies_around` K3's launches}. A trace
    that misses a K3 launch is taken again (PERF.md §7)."""
    planes = wide_heads_planes()
    out = {}
    for d in WIDE_ENCODER_HEAD_DIMS:
        with tempfile.TemporaryDirectory() as ckpt:
            write_wide_config(ckpt, d)
            enc = FrameEncoder(ckpt, random_init=True, device="cuda")
            body = fa.attention_body("attention_headmajor", torch.bfloat16, d)
            marker = "attention_sm90" if body in fa.BF16_BODIES else "attention_wide_bf16"
            enc.encode_planes(planes)  # warm: the geometry's state
            for _ in range(TRACE_TRIES):
                out[d] = copies_around(trace_kernels(torch, lambda: enc.encode_planes_async(
                    planes, batch=WIDE_ENCODER_FRAMES)), marker)  # noqa: B023
                if out[d]["launches"] == WIDE_ENCODER_DEPTH - 1:
                    break
            del enc
    return out


def wide_heads_phase(torch, fa, FrameEncoder, init_vit_params, card, traces) -> tuple:
    """Phase 12: an encoder at each of WIDE_ENCODER_HEAD_DIMS (8 heads, depth
    2, opened from a checkpoint directory's config.json with random weights)
    on WIDE_ENCODER_FRAMES frames of 256x256 in bf16: K3 once a forward
    through the Hopper body up to 256 (with one staging launch where a row
    is no 16-byte multiple) and the wide body at 320, no copy kernel next to
    it in a profiler trace of one forward; the embeddings against the CPU
    fp32 run. Then K3 alone at the shape that path gives it (the frames as
    the batch, the encoder's heads, tokens and RoPE tables) against its
    plain version, timed, after the launches are read, and where it stages
    the staging pass alone (:func:`staging_case`). At
    WIDE_ENCODER_FP32_HEAD_DIMS the same encoder
    in fp32 too (``runtime.compute_dtype: float32``): K3 through the fp32
    Hopper body's wide form, the embeddings within the fp32 encode bound of
    the CPU run, and K3 alone in fp32 at that shape. Returns ({head dim:
    launches}, {head dim: that kernel case}, {head dim: the fp32 launches},
    {head dim: the fp32 kernel case})."""
    planes = wide_heads_planes()
    runs, cases, runs32, cases32 = {}, {}, {}, {}
    for d in WIDE_ENCODER_HEAD_DIMS:
        with tempfile.TemporaryDirectory() as ckpt:
            hidden = write_wide_config(ckpt, d)
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
                    "sm90_ws": per * (body == "sm90_ws"),
                    "staging": per * fa.headmajor_staged(torch.bfloat16, d, True),
                    "headmajor_by_dim": {fa.headmajor_width(torch.bfloat16, d): per},
                    LN_KERNEL: ln_per_forward(WIDE_ENCODER_DEPTH) * forwards,
                    "projection_gemms": projections_per_run(per, forwards)}
            if {key: got[key] for key in want} != want:
                raise AssertionError(f"{d}-wide heads launched {got}, expected {want}")
            if emb.shape != (WIDE_ENCODER_FRAMES, hidden) or not np.isfinite(emb).all():
                raise AssertionError(f"{d}-wide heads: embeddings {emb.shape}, "
                                     f"finite={np.isfinite(emb).all()}")
            # One forward traced (before phase 8: :func:`wide_heads_traces`):
            # no copy kernel next to K3, past its RoPE prologue or staging pass.
            copies = traces[d]
            if copies["launches"] != WIDE_ENCODER_DEPTH - 1 or copies["copies_around"]:
                raise AssertionError(f"{d}-wide heads: copies next to K3: {copies}")
            fps = warm_fps(torch, enc, planes, WIDE_ENCODER_FRAMES, 3)
            grid = (256 // enc.cfg.patch_size,) * 2
            n_tokens = enc.cfg.num_prefix_tokens + grid[0] * grid[1]
            case = kernel_case(torch, fa, enc.cfg, "attention_headmajor", WIDE_ENCODER_FRAMES,
                               WIDE_ENCODER_HEADS, n_tokens, d, grid, torch.bfloat16, True)
            if fa.headmajor_staged(torch.bfloat16, d, True):
                case.update(staging_case(torch, fa, enc.cfg, WIDE_ENCODER_FRAMES, n_tokens,
                                       WIDE_ENCODER_HEADS, d, grid, True))
            case["phase"] = "kernel_wide_heads"
            emit(case)
            if not case["ok"] or case["body"] != body:
                raise AssertionError(f"K3 at phase 12's shape, d {d}: {case}")
            params = init_vit_params(SEED, enc.cfg)
            del enc
            cpu = FrameEncoder(ckpt, params=params, compute_dtype=torch.float32, device="cpu")
            ref = cpu.encode_planes(planes[:N_CHECK_7B]).astype(np.float32)
            cos = row_cosine(emb[:N_CHECK_7B], ref)
            del cpu
            if d in WIDE_ENCODER_FP32_HEAD_DIMS:
                runs32[d], cases32[d] = wide_heads_fp32(torch, fa, FrameEncoder, ckpt, params,
                                                        planes, ref, d, card)
        line = {"phase": "encode_wide_heads", "route": "head-major (K3)", "body": body,
                "model": f"{WIDE_ENCODER_HEADS} heads x {d} (hidden {hidden}, gated MLP "
                         f"{2 * hidden}), depth {WIDE_ENCODER_DEPTH}, random weights",
                "dtype": "bfloat16", "frames": WIDE_ENCODER_FRAMES, "forwards": forwards,
                "launches": got, "expected_launches": want, "main_path_s": path_s,
                "one_forward_trace": copies,
                "warm_fps_256": fps, "bf16_min_cos_vs_cpu_fp32": float(cos.min()),
                "tol_min_cos": ENCODE_BF16_MIN_COS, "card": card,
                "ok": bool(cos.min() >= ENCODE_BF16_MIN_COS)}
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"{d}-wide heads: embeddings disagree with the CPU fp32 run")
        runs[d], cases[d] = got, case
        torch.cuda.empty_cache()
    return runs, cases, runs32, cases32


def wide_heads_fp32(torch, fa, FrameEncoder, ckpt, params, planes, ref, d, card) -> tuple:
    """Phase 12 in fp32 at d: the encoder at ``ckpt`` with ``params`` in
    fp32 on the card, its counts set to 0 before N_CHECK_7B frames and read
    after: K3 once a forward, each launch through the fp32 Hopper body's
    wide form (d up to 256) or its slices body (above) with one launch of
    their prologue; the embeddings within 1 fp16
    ulp + 1e-4 of the CPU fp32 run ``ref``. Then K3 alone in fp32 at the
    shape that path gives it, against its plain version, timed. Returns
    (launches, that kernel case)."""
    enc = FrameEncoder(ckpt, params=params, compute_dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    reset_launches(fa)
    g32 = enc.encode_planes(planes[:N_CHECK_7B]).astype(np.float32)
    got = read_launches(fa)
    body = fa.attention_body("attention_headmajor", torch.float32, d)
    per = WIDE_ENCODER_DEPTH - 1  # one forward; the CLS-only last block is plain
    want = {"attention_fat": 0, "attention_packed": 0, "attention_headmajor": per,
            "sm90": 0, "sm90_f32": 0, "sm90_f32_wide": per * (body == "sm90_f32_wide"),
            "sm90_f32_slices": per * (body == "sm90_f32_slices"), "tf32_prologue": per,
            "wide": 0, "headmajor_by_dim": {fa.headmajor_width(torch.float32, d): per}}
    if body != ("sm90_f32_wide" if d <= 256 else "sm90_f32_slices") \
            or {key: got[key] for key in want} != want:
        raise AssertionError(f"fp32 {d}-wide heads launched {got} on {body}, expected {want}")
    err = np.abs(g32 - ref)
    ulp = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
    grid = (256 // enc.cfg.patch_size,) * 2
    fps = warm_fps(torch, enc, planes, WIDE_ENCODER_FRAMES, 3)
    case = kernel_case(torch, fa, enc.cfg, "attention_headmajor", WIDE_ENCODER_FRAMES,
                       WIDE_ENCODER_HEADS, enc.cfg.num_prefix_tokens + grid[0] * grid[1], d, grid,
                       torch.float32, True)
    case["phase"] = "kernel_wide_heads_fp32"
    emit(case)
    line = {"phase": "encode_wide_heads_fp32", "route": "head-major (K3)", "body": body,
            "head_dim": d, "dtype": "float32", "frames": N_CHECK_7B, "launches": got,
            "expected_launches": want, "fp32_max_abs_err": float(err.max()),
            "fp32_max_fp16_ulps": float((err / ulp).max()),
            "fp32_tol": f"{ENCODE_FP32_ULPS} fp16 ulp + {ENCODE_FP32_FLOOR}",
            "warm_fps_256": fps, "card": card,
            "ok": bool(np.isfinite(g32).all() and g32.shape == ref.shape
                       and (err <= ENCODE_FP32_ULPS * ulp + ENCODE_FP32_FLOOR).all())}
    emit(line)
    if not line["ok"] or not case["ok"] or case["body"] != body:
        raise AssertionError(f"fp32 {d}-wide heads disagree: {line}, {case}")
    del enc
    return got, case


def ln_kernel_entry(ln_cases, route_launches, fp32_runs, mesh_launches, tools_line,
                    wide_runs) -> dict:
    """The ``kernels`` line's entry for the LayerNorm kernel: its launches on
    the flat route's main path (and on every other route, run and phase),
    its numbers at dinov3-vitb16 256x256 batch 128 (bf16, fused,
    single-pass), and its other timed cases beside them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "mbytes", "share_of_bound", "floor_ms", "kernel", "ptxas")
    main = ln_cases["main"][0]
    return {
        "name": LN_KERNEL, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{LN_KERNEL}.cu",
        "replaces": LN_REPLACES, "launches": route_launches["attention_fat"][LN_KERNEL],
        "launches_by_route": {name: run[LN_KERNEL] for name, run in route_launches.items()}
        | {f"wide_heads_d{d}": run[LN_KERNEL] for d, run in wide_runs.items()},
        **{key: main[key] for key in keys},
        "shape": [main["rows"], main["D"]], "what": main["what"],
        "at_other_shapes": [
            {key: c[key] for key in keys}
            | {key: c[key] for key in ("rows", "D", "dtype", "residual", "two_pass", "x", "what")}
            for c in ln_cases["main"][1:] + ln_cases["other"]],
        "launches_fp32": {name: run[LN_KERNEL] for name, run in fp32_runs.items()},
        "launches_mesh": mesh_launches[LN_KERNEL],
        "launches_tools": {run: got[LN_KERNEL] for run, got in tools_line["launches"].items()},
    }


def floor_kernel_entry(floor) -> dict:
    """The ``kernels`` line's entry for the memory floor: its launches over
    the floor phase, its numbers at probe14's own (B*G, N, 128) blocks, and
    every other row's beside them."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "copy_ms",
            "gbps", "copy_gbps", "share_of_peak", "mbytes", "bit_equal_where_not_nan",
            "nan_bits_equal")
    main = floor["cases"][0]
    return {
        "name": FLOOR_KERNEL, "route": "cuda", "source": f"cbas_tpu_torch/csrc/{FLOOR_KERNEL}.cu",
        "replaces": FLOOR_REPLACES, "sites": list(FLOOR_SITES), "launches": floor["launches"],
        **{key: main[key] for key in keys}, "shape": main["shape"], "dtype": main["dtype"],
        "library": "none computes q + 0*k + 0*v in one call; copy_ms is out.copy_(q), the "
                   "card's copy rate over half the bytes",
        "ptxas": list(PTXAS.get(FLOOR_KERNEL, {}).items()),
        "at_rows": [{key: c[key] for key in ("what", "shape", "dtype", "mbytes", "ms", "gbps",
                                             "copy_ms", "copy_gbps", "bound_ms", "share_of_peak")}
                    for c in floor["cases"][1:]],
        "chain": floor["chain"],
    }


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
            "ms_norope", "gflop", "mbytes", "floor_ms", "ptxas")},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "share_of_bound": main["bound_ms"] / main["ms"],
        "other_cases": cases,
    }


WS_SOURCE = "cbas_tpu_torch/csrc/attention_sm90_ws.cuh"


def ws_registers() -> dict:
    """ptxas's report of each build of the two-consumer body in the
    libraries built (PTXAS), {"<library>: <label>": {"registers_at_entry",
    "spill_stores", "spill_loads", "setmaxnreg_ignored"}}: the registers
    it gives a thread at entry (its ``__launch_bounds__``), its spill bytes,
    and whether it warned that it ignored the kernel's setmaxnreg (C7508).
    Raises where a build spills or that warning appeared, or none was
    built."""
    out = {}
    for lib, reports in PTXAS.items():
        for label, report in reports.items():
            if label.startswith("sm90_ws<"):
                m = re.match(r"(\d+) regs, (\d+)/(\d+) spill", report)
                out[f"{lib}: {label}"] = {
                    "registers_at_entry": int(m[1]), "spill_stores": int(m[2]),
                    "spill_loads": int(m[3]), "setmaxnreg_ignored": "setmaxnreg ignored" in report}
    bad = {k: r for k, r in out.items()
           if r["spill_stores"] or r["spill_loads"] or r["setmaxnreg_ignored"]}
    if not out or bad:
        raise AssertionError(f"the two-consumer body's ptxas reports: {bad or 'none built'}")
    return out


# The bf16 Hopper bodies' builds at the widths between 64, 128 and 192 and
# the two-consumer body's: map rank 4 and 5, and the staged form.
BF16_BUILDS = tuple(f"{body}<{w}, {form}>" for body, widths in (("sm90", (96, 160)),
                                                                 ("sm90_ws", (224, 256)))
                    for w in widths for form in ("4", "5", "4, staged"))


def bf16_builds() -> dict:
    """ptxas's report of each BF16_BUILDS kernel in K3's library (PTXAS),
    {"attention_headmajor: <label>": {"registers", "spill_stores",
    "spill_loads", "wgmma_serialized", "setmaxnreg_ignored"}}. Raises where
    a build spills, has its wgmmas serialized or its setmaxnreg ignored
    (C7508), or is missing."""
    out = {}
    for label, report in PTXAS.get("attention_headmajor", {}).items():
        if label in BF16_BUILDS:
            m = re.match(r"(\d+) regs, (\d+)/(\d+) spill", report)
            out[f"attention_headmajor: {label}"] = {
                "registers": int(m[1]), "spill_stores": int(m[2]), "spill_loads": int(m[3]),
                "wgmma_serialized": "wgmma serialized" in report,
                "setmaxnreg_ignored": "setmaxnreg ignored" in report}
    missing = [b for b in BF16_BUILDS if f"attention_headmajor: {b}" not in out]
    bad = {k: r for k, r in out.items() if r["spill_stores"] or r["spill_loads"]
           or r["wgmma_serialized"] or r["setmaxnreg_ignored"]}
    if missing or bad:
        raise AssertionError(f"the bf16 bodies' ptxas reports: {bad}; not built: {missing}")
    return out


def ws_kernel_entry(tools_line, wide_runs, wide_cases) -> dict:
    """The ``kernels`` line's entry for the two-consumer body
    (``attention_sm90_ws.cuh``, K3's bf16 heads from 193 to 256): its
    launches over phase 12's encodes (one a forward at 256-wide heads), its
    numbers from phase 12's kernel case at 256 (the shape that encode gives
    it), ptxas's report of each build of it, phase 10's cases
    (``ws_cases_step``) and its timed padded-width cases beside them."""
    main = wide_cases[256]
    if main["body"] != "sm90_ws":
        raise AssertionError(f"phase 12's 256-wide heads ran the {main['body']} body")
    return {
        "name": "attention_headmajor_sm90_ws", "route": "cuda", "source": WS_SOURCE,
        "replaces": KERNELS["attention_headmajor"],
        "launches": sum(run["sm90_ws"] for run in wide_runs.values()),
        "launches_by_head_dim": {d: run["sm90_ws"] for d, run in wide_runs.items()},
        "body": "sm90_ws", **{key: main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "gflop", "mbytes", "floor_ms", "ptxas")},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "share_of_bound": main["bound_ms"] / main["ms"],
        "ptxas_builds": ws_registers(),
        "ptxas_bf16_builds": bf16_builds(),
        "card_cases": tools_line["ws_cases"],
        "padded_cases": [c for c in tools_line["padded_timings"] if c["body"] == "sm90_ws"],
    }


def staging_kernel_entry(tools_line, wide_runs, wide_cases) -> dict:
    """The ``kernels`` line's entry for bf16's staging pass (``stage_rows``
    in ``attention_common.cuh``, part of K3's port): its launches over phase
    12's encodes (one a forward at 100), its numbers at phase 12's d 100
    (the pass alone, bit for bit its plain version), and phase 10's staged
    cases beside them."""
    staged = {d: c for d, c in wide_cases.items() if "staging_ms" in c}
    if not staged:
        raise AssertionError("phase 12 ran no staged head")
    main = staged[min(staged)]
    others = [c for c in tools_line["padded_timings"] + tools_line["wide_odd_timings"]
              if "staging_ms" in c]
    return {
        "name": "attention_bf16_stage", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_common.cuh",
        "replaces": KERNELS["attention_headmajor"],
        "launches": sum(run["staging"] for run in wide_runs.values()),
        "launches_by_head_dim": {d: run["staging"] for d, run in wide_runs.items()},
        "max_abs_err": 0.0 if main["staging_bit_equal"] else float("nan"),
        "ms": main["staging_ms"], "ms_norope": main["staging_norope_ms"],
        "plain_ms": main["staging_plain_ms"], "bound_ms": main["staging_bound_ms"],
        "bound_by": "bytes", "gbps": main["staging_gbps"], "library_ms": None,
        "library": "none: no one PyTorch call pads, ropes and scales three tensors",
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "ptxas": [f"{k}: {v}" for k, v in PTXAS.get("attention_headmajor", {}).items()
                  if k.startswith("stage_rows<")],
        "at_other_shapes": [{key: c[key] for key in ("B", "N", "H", "head_dim", "rope")
                             + STAGING_KEYS} for c in others],
    }


def tf32_wide_kernel_entry(tools_line, runs32, cases32) -> dict:
    """The ``kernels`` line's entry for the fp32 Hopper body's wide form
    (``attention_sm90_tf32_wide.cuh``): its launches over phase 12's fp32
    encodes at 192- and 256-wide heads, its numbers from phase 12's fp32
    kernel case at 256 (the shape that encode gives it), phase 10's fp32
    cases on it beside them, and validate_kernels' launches and largest
    error at TOOLS_FP32_GEOMETRIES."""
    cases32 = {d: c for d, c in cases32.items() if d <= 256}
    main = cases32[max(cases32)]
    if main["body"] != "sm90_f32_wide":
        raise AssertionError(f"phase 12's fp32 heads ran the {main['body']} body")
    validate = tools_line["validate_kernels"]
    return {
        "name": "attention_sm90_tf32_wide", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_sm90_tf32_wide.cuh",
        "replaces": KERNELS["attention_headmajor"], "body": "sm90_f32_wide",
        "launches": sum(run["sm90_f32_wide"] for run in runs32.values()),
        "launches_by_head_dim": {d: run["sm90_f32_wide"] for d, run in runs32.items()
                                 if d in cases32},
        "launches_validate_kernels": validate["expected_launches"]["sm90_f32_wide"],
        **{key: main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "gflop", "mbytes", "floor_ms", "ptxas", "share_of_bound")},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "at_other_shapes": [c for c in tools_line["padded_timings"]
                            if c["body"] == "sm90_f32_wide"]
        + [{key: c[key] for key in ("head_dim", "ms", "ms_norope", "max_abs_err", "bound_ms")}
           for d, c in cases32.items() if c is not main],
        "validate_kernels_max_f32_err": validate["max_f32_err_wide"],
    }


def tf32_slices_kernel_entry(tools_line, runs32, cases32) -> dict:
    """The ``kernels`` line's entry for the fp32 Hopper body's slices form
    (``attention_sm90_tf32_slices.cuh``, fp32 heads above 256): its launches
    over phase 12's fp32 encode at 320-wide heads (the main path), its
    numbers from phase 12's fp32 kernel case at 320 (the shape that encode
    gives it), phase 10's fp32 cases on it beside them (with its slices,
    their extra FLOP and its prologue), and validate_kernels' launches and
    largest error at 320 and 384."""
    main = cases32[max(cases32)]
    if main["body"] != "sm90_f32_slices":
        raise AssertionError(f"phase 12's widest fp32 heads ran the {main['body']} body")
    validate = tools_line["validate_kernels"]
    return {
        "name": "attention_sm90_tf32_slices", "route": "cuda",
        "source": "cbas_tpu_torch/csrc/attention_sm90_tf32_slices.cuh",
        "replaces": KERNELS["attention_headmajor"], "body": "sm90_f32_slices",
        "launches": sum(run["sm90_f32_slices"] for run in runs32.values()),
        "launches_prologue": sum(run["tf32_prologue"] for d, run in runs32.items() if d > 256),
        "launches_validate_kernels": validate["expected_launches"]["sm90_f32_slices"],
        **{key: main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library",
            "ms_norope", "gflop", "mbytes", "floor_ms", "ptxas", "share_of_bound")},
        "shape": [main[x] for x in ("B", "N", "H", "head_dim")],
        "at_other_shapes": [c for c in tools_line["wide_odd_timings"]
                            if c["body"] == "sm90_f32_slices"],
        "validate_kernels_max_f32_err": validate["max_f32_err_slices"],
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
                line["launches"] = app_launches(fa, on_card, 1, api.state.encoder.cfg.num_layers)
                line["ran"].append("the app's encoder on one clip")
            else:
                n_all = DEMO_CLIPS * DEMO_FRAMES
                wait_for("encode queue", lambda: app_drained(port, DEMO_CLIPS))
                line["encode_frames_per_s"] = n_all / (time.perf_counter() - t0 - line["load_s"])
                chunk = api.state.project.settings.encode.chunk_frames
                # a clip shorter than a device batch is one snapped batch
                per_clip = 1 if DEMO_FRAMES < chunk else -(-DEMO_FRAMES // chunk)
                line["launches"] = app_launches(fa, on_card, DEMO_CLIPS * per_clip,
                                                api.state.encoder.cfg.num_layers)
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


def app_launches(fa, on_card, forwards, layers) -> dict:
    """The app's encoder (``layers`` blocks) went through K1 only, once a
    block but the last, each launch through the Hopper body, and through the
    LayerNorm kernel 2L + 1 times a forward (on the card; the CPU runs the
    plain versions)."""
    got = read_launches(fa)
    if on_card:
        return check_launches("app", got, "attention_fat", layers - 1, forwards, sm90=True,
                              ln_per=ln_per_forward(layers))
    if any(n for name, n in got.items() if name != "projection_gemms"):
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


# 9b. The desktop shell's backend contract: the port's shell
# (cbas_tpu_torch/shell/main.js) spawns BACKEND_ARGS from the repository root
# and scrapes the backend's stdout for READY_RE; stopBackend sends SIGTERM to
# the backend's process group.
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
SHELL_MAIN_JS = os.path.join(REPO_ROOT, "cbas_tpu_torch", "shell", "main.js")
SHELL_EXIT_S = 30  # the deadline of the backend's exit after SIGTERM


def shell_contract() -> tuple:
    """(READY_RE compiled, BACKEND_ARGS) as the port's shell defines them."""
    with open(SHELL_MAIN_JS) as f:
        src = f.read()
    ready = re.search(r"const READY_RE = /(.+?)/;", src)
    args = re.search(r"const BACKEND_ARGS = \[(.+?)\];", src)
    if not ready or not args:
        raise AssertionError(f"{SHELL_MAIN_JS} must define READY_RE and BACKEND_ARGS")
    return (re.compile(ready.group(1).replace("\\/", "/")),
            [a.strip().strip("'\"") for a in args.group(1).split(",")])


def _pump(stream, lines) -> None:
    """Every line of ``stream`` into the queue ``lines``, then None."""
    for text in stream:
        lines.put(text)
    lines.put(None)


def shell_phase(card, device="cuda") -> dict:
    """Phase 9b: the backend started as the desktop shell starts it (its own
    BACKEND_ARGS, from the repository root, PYTHONUNBUFFERED=1, a session of
    its own), driven over HTTP on a copy of the demo project, then stopped as
    the shell stops it: SIGTERM to its process group, which must leave no
    process. Returns the phase line. (``device="cpu"`` appends ``--device
    cpu``: only the CPU test of this function passes it.)"""
    import queue
    import shutil
    import signal
    import threading
    import urllib.request

    ready_re, backend_args = shell_contract()
    argv = [sys.executable, *backend_args] + (["--device", "cpu"] if device == "cpu" else [])
    line = {"phase": "shell", "backend_args": backend_args, "device": device}
    with tempfile.TemporaryDirectory() as d:
        proj = os.path.join(d, "demo")
        shutil.copytree(DEMO_PROJECT, proj)
        if host_missing(("h5py",)):
            # Without h5py the encode worker could only fail each clip: queue none.
            shutil.rmtree(os.path.join(proj, "recordings"))
            os.makedirs(os.path.join(proj, "recordings"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=REPO_ROOT, env={**os.environ, "PYTHONUNBUFFERED": "1"},
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        lines = queue.Queue()
        reader = threading.Thread(target=_pump, args=(proc.stdout, lines), daemon=True)
        reader.start()
        try:
            url, seen = None, []
            deadline = time.time() + APP_WAIT_S
            while url is None:
                try:
                    text = lines.get(timeout=max(deadline - time.time(), 0))
                except queue.Empty:
                    raise AssertionError(f"shell: no ready line after {APP_WAIT_S} s") from None
                if text is None:
                    raise AssertionError(f"shell: the backend exited ({proc.wait()}) before "
                                         f"its ready line: {''.join(seen[-20:])}")
                seen.append(text)
                match = ready_re.search(text)
                url = match and match.group(1)
            line["ready_s"] = time.perf_counter() - t0
            port = int(url.rsplit(":", 1)[1])

            if rpc(port, "get_cbas_status")["project_loaded"]:
                raise AssertionError("shell: a project is loaded before load_project")
            t = time.perf_counter()
            if not rpc(port, "load_project", proj)["success"]:
                raise AssertionError("shell: load_project failed")
            line["load_s"] = time.perf_counter() - t
            status = rpc(port, "get_cbas_status")
            line["encoder_device"] = status["encoder_device"]
            if not (status["project_loaded"] and status["encoder_ready"]
                    and str(status["encoder_device"]).startswith(device)):
                raise AssertionError(f"shell: the encoder is not ready on {device}: {status}")
            with urllib.request.urlopen(url + "/", timeout=30) as resp:
                if b"<html" not in resp.read().lower():
                    raise AssertionError("shell: GET / served no page")
        except BaseException:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise

        # stopBackend: SIGTERM to the group, then nothing of it may be left
        t = time.perf_counter()
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            line["returncode"] = proc.wait(timeout=SHELL_EXIT_S)
        except subprocess.TimeoutExpired:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"shell: the backend outlived SIGTERM by {SHELL_EXIT_S} s") \
                from None
        line["exit_s"] = time.perf_counter() - t
        reader.join(timeout=SHELL_EXIT_S)
        # The group's other processes end after the leader and are reaped by
        # their own parents: wait for the group to empty, not one probe right
        # after the leader's exit, within SHELL_EXIT_S of the SIGTERM.
        while True:
            try:
                os.killpg(proc.pid, 0)
            except ProcessLookupError:
                break
            if time.perf_counter() - t > SHELL_EXIT_S:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                raise AssertionError(f"shell: a process of the backend's group outlived "
                                     f"SIGTERM by {SHELL_EXIT_S} s")
            time.sleep(0.05)
        line["group_exit_s"] = time.perf_counter() - t
    if line["returncode"] not in (0, -signal.SIGTERM):
        raise AssertionError(f"shell: the backend exited {line['returncode']} on SIGTERM")
    line["card"] = card
    line["ok"] = True
    emit(line)
    return line


def demo_phase(card, device="cuda") -> dict:
    """Phase 9c: the port's scripted demo
    (``cbas_tpu_torch/examples/end_to_end_demo.py``) on ``device`` in a
    temporary directory, where the host has the packages it needs; its
    seconds and the two mean probabilities, each above 0.5. Returns the
    phase line."""
    from cbas_tpu_torch.examples import end_to_end_demo as demo

    missing = host_missing(demo.REQUIRED)
    if missing:
        line = {"phase": "demo", "skipped": f"not installed: {', '.join(missing)}"}
        emit(line)
        return line
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(sys.stderr):
        t = time.perf_counter()
        got = demo.main(d, device)
        seconds = time.perf_counter() - t
    line = {"phase": "demo", "device": device, "demo_s": seconds, "p_active": got["p_active"],
            "p_rest": got["p_rest"], "card": card}
    if not (got["p_active"] > 0.5 and got["p_rest"] > 0.5):
        raise AssertionError(f"demo: the head did not learn the two behaviours: {line}")
    line["ok"] = True
    emit(line)
    return line


# 10. The tools. validate_kernels runs its bf16 check at the last geometry it
# is given, so this one, DINOv3 ViT-7B's heads, sends K3 in bf16 through the
# Hopper body.
TOOLS_EXTRA_GEOMETRY = (2, 32, 261, 128, True)
# Before it, fp32 K3 through the fp32 Hopper body's wide form at the widths
# it is built at and at one it reads on maps at d (200 at 256), and through
# its slices body at 320 and 384, each held to fp64 within CARD_TOL_F32.
TOOLS_FP32_GEOMETRIES = ((2, 8, 261, 192, True), (2, 8, 261, 256, False), (2, 8, 261, 200, True),
                         (2, 8, 261, 320, True), (2, 4, 261, 384, False))
# K3 at head dims between its builds, (B, N, H, d), all with no copy: in
# bf16 the card runs 100 at 128 and 136 at 160 through the staging launch
# (rows off 32 bytes below 193), 160 at its own build and 200 and 248 at 224
# and 256 on maps at d (rows off 32 bytes read in place); in fp32 it runs
# 100 at 128 on the fp32 Hopper body and the rest at 192 and 256 on its wide
# form.
PADDED_CASES = ((8, 261, 16, 100), (8, 261, 16, 136), (8, 261, 16, 160), (8, 261, 16, 200),
                (8, 261, 16, 248), (4, 1205, 16, 100))
# bf16 only, beside them: multiples of 8 below 128 other than 64 (32 on maps
# at d at 64, 96 at its own build) at N 261 and 1205, and 150 (no multiple
# of 8, staged, at 160) at N 1205.
BF16_WIDTH_CASES = ((8, 261, 16, 32), (8, 261, 16, 96), (4, 1205, 16, 96), (4, 1205, 16, 150))
# K3 in bf16 at the card tests' set for the widths between the builds and
# the two-consumer body (bf16 K3 from 193 to 256; 129-192 keep the Hopper
# body): 96, 160 and 224 at their own builds, 136 staged (a row off 32 bytes
# below 193), 200, 232 and 248 read in place (rows off 32 bytes on the
# two-consumer body, at 224 and 256), 192 and 256 at theirs; N 261 and 1205
# and 272 / 261 and 1216 / 1205 with NaN in the dead rows; RoPE on and off;
# contiguous tensors and head-major views of one fused projection
# (``ws_cases_step``).
WS_CASE_DIMS = (96, 136, 160, 192, 200, 224, 232, 248, 256)
WS_CASE_ROWS = ((261, None), (272, 261), (1205, None), (1216, 1205))
# fp32 only, beside them: the wide form at the widths it is built at, at
# N 261 and at 640x480's 1205 tokens.
TF32_WIDE_CASES = ((8, 261, 16, 192), (8, 261, 16, 256), (4, 1205, 16, 192), (4, 1205, 16, 256))
# and the fp32 body at 64 at small widths on maps at d, beside their floor,
# SDPA and plain version.
TF32_SMALL_CASES = ((8, 261, 16, 16), (8, 261, 16, 32))


def padded_runs(torch) -> list:
    """(B, N, H, d, dtype) of phase 10's padded-width cases: PADDED_CASES in
    bf16 and fp32, BF16_WIDTH_CASES in bf16, then TF32_WIDE_CASES and
    TF32_SMALL_CASES in fp32."""
    return [(*case, dtype) for case in PADDED_CASES for dtype in (torch.bfloat16, torch.float32)] \
        + [(*case, torch.bfloat16) for case in BF16_WIDTH_CASES] \
        + [(*case, torch.float32) for case in TF32_WIDE_CASES + TF32_SMALL_CASES]
# K3 at the head dims it refused on the card before, (B, N, H, d), with RoPE:
# wider than 256 (the wide body, d at run time) and odd (bf16: roped by the
# staging launch, fp32: by the wrapper, then zero-padded). d 320 and 384 take
# the model's tables at that width; d 65 random angles (``head_tables``).
WIDE_ODD_CASES = ((8, 261, 16, 320), (4, 1205, 8, 384), (8, 261, 16, 65))
# fp32 only, beside them, (B, N, H, d, n_valid): an odd d above 256 on the
# fp32 slices body, Q staged without the TMA (rows no 16-byte multiple), NaN
# in the dead K/V rows, roped by the wrapper before the launch.
WIDE_ODD_FP32_CASES = ((2, 272, 4, 301, 261),)
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
# h5py, pandas, OpenCV and matplotlib. Both of the fleet step's encodes (the
# fleet's worker and the in-process one it is held against, bit for bit)
# run at FLEET_THREADS intra-op threads, with MKL's and OpenMP's dynamic
# teams off, so no side picks its team at run time.
FLEET_CLIPS, FLEET_FRAMES = 2, 100
FLEET_THREADS = 2
SOAK_CAMERAS, SOAK_MINUTES = 2, 0.5


def tools_phase(torch, fa, cfg, params, card, calls) -> dict:
    """Phase 10: validate_kernels on the card, K3 at padded widths (``calls``:
    the kernels one call launches there, from phase 2), the CLS attention
    map, and (where the host can) encode_fleet and soak. Returns
    the phase line, with the padded cases' timings and the launches of each
    run for the kernels line."""
    line = {"phase": "tools", "card": card, "launches": {}}
    t = time.perf_counter()
    line["validate_kernels"] = validate_kernels_step(torch, fa, line["launches"])
    line["ws_cases"] = ws_cases_step(torch, fa, cfg, line["launches"])
    cases = padded_cases(torch, fa, cfg, calls)
    line["padded_timings"] = [{key: c[key] for key in (
        "B", "N", "H", "head_dim", "padded_to", "dtype", "rope", "body", "max_abs_err", "tol",
        "ms", "built_width_ms", "ms_norope", "plain_ms", "bound_ms", "bound_by", "floor_ms",
        "gflop", "mbytes", "library_ms", "library", "ptxas", "k3_launches_per_call",
        "body_launches_per_call", "staging_launches_per_call", "kernels_per_call",
        "gpu_clocks")}
        | {key: c[key] for key in STAGING_KEYS if key in c} for c in cases]
    wide = wide_odd_cases(torch, fa, cfg)
    line["wide_odd_timings"] = [{key: c[key] for key in (
        "B", "N", "H", "head_dim", "n_valid", "padded_to", "dtype", "rope", "body",
        "max_abs_err", "tol", "ms", "ms_norope", "plain_ms", "bound_ms", "bound_by", "floor_ms",
        "gflop", "mbytes", "library_ms", "library", "ptxas")}
        | {key: c[key] for key in SLICES_KEYS + STAGING_KEYS if key in c} for c in wide]
    line["cls_attention_map"] = attention_map_step(torch, fa, cfg, params, line["launches"])
    missing = host_missing(("h5py", "pandas", "cv2", "matplotlib"))
    if missing:
        line["skipped"] = {step: f"not installed: {', '.join(missing)}"
                           for step in ("encode_fleet", "soak")}
    else:
        line["encode_fleet"] = fleet_step()
        line["soak"] = soak_step()
    line["seconds"] = time.perf_counter() - t
    line["ok"] = True
    emit(line)
    return line


def validate_kernels_step(torch, fa, launches) -> dict:
    """``validate_kernels.main`` on the card at its geometries plus
    TOOLS_FP32_GEOMETRIES and TOOLS_EXTRA_GEOMETRY: every check under its
    tolerance, K1, K2 and K3 launched as the geometries say, K3's bf16 check
    through the Hopper body and every fp32 check through the fp32 Hopper
    body (head dims 64 and 128), its wide form (192, 200, 256) or its slices
    body (320, 384)."""
    import io

    from cbas_tpu_torch.tools import validate_kernels

    geometries = list(validate_kernels.GEOMETRIES) + list(TOOLS_FP32_GEOMETRIES) \
        + [TOOLS_EXTRA_GEOMETRY]
    records, printed = [], io.StringIO()
    torch.cuda.synchronize()
    reset_launches(fa)
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = validate_kernels.main(geometries, device="cuda", records=records)
    seconds = time.perf_counter() - t
    got = read_launches(fa)
    launches["validate_kernels"] = got
    # one K3 call a geometry and the bf16 check; where d = 64 and H is even K1
    # and K2 on contiguous tensors, and K1, K2 and K3 on fused q|k|v views
    pairs = sum(1 for _, H, _, d, _ in geometries if d == 64 and H % 2 == 0)
    last_d = geometries[-1][3]
    sm90 = int(fa.attention_body("attention_headmajor", torch.bfloat16, last_d) == "sm90")
    fp32 = sum(1 + 5 * (d == 64 and H % 2 == 0) for _, H, _, d, _ in geometries
               if fa.attention_body("attention_headmajor", torch.float32, d) == "sm90_f32")
    fp32_wide, fp32_slices = (
        sum(1 for _, _, _, d, _ in geometries
            if fa.attention_body("attention_headmajor", torch.float32, d) == body)
        for body in ("sm90_f32_wide", "sm90_f32_slices"))
    want = {"attention_fat": 2 * pairs, "attention_packed": 2 * pairs,
            "attention_headmajor": len(geometries) + 1 + pairs, "sm90": sm90,
            "sm90_f32": fp32, "sm90_f32_wide": fp32_wide, "sm90_f32_slices": fp32_slices,
            "tf32_prologue": fp32 + fp32_wide + fp32_slices,
            LN_KERNEL: 2}  # its single-pass and two-pass LayerNorm checks
    k3_only = {"sm90_f32_wide": got["sm90_f32_wide"], "sm90_f32_slices": got["sm90_f32_slices"],
               "wide": got["wide"], "sm90_ws": got["sm90_ws"]}
    by_body = {name: {"sm90": got["sm90_by_kernel"].get(name, 0),
                      "sm90_f32": got["sm90_f32_by_kernel"].get(name, 0),
                      **{body: n if name == "attention_headmajor" else 0
                         for body, n in k3_only.items()}}
               for name in KERNELS}
    unreported = {name: got[name] - sum(by_body[name].values()) for name in KERNELS}
    f32_errs = {body: [r["err"] for r in records if "vs fp64" in r["check"] and any(
                    f" d{d} " in r["check"] for _, _, _, d, _ in TOOLS_FP32_GEOMETRIES
                    if fa.attention_body("attention_headmajor", torch.float32, d) == body)]
                for body in ("sm90_f32_wide", "sm90_f32_slices")}
    out = {"rc": rc, "geometries": geometries, "checks": records, "seconds": seconds,
           "launches_by_body": by_body, "expected_launches": want,
           "tol_f32": validate_kernels.CARD_TOL_F32,
           "max_f32_err": max(r["err"] for r in records if "vs fp64" in r["check"]),
           "max_f32_err_wide": max(f32_errs["sm90_f32_wide"]),
           "max_f32_err_slices": max(f32_errs["sm90_f32_slices"]),
           "printed": printed.getvalue().splitlines()}
    bad = [r for r in records if not r["ok"]]
    if rc != 0 or bad or not records:
        raise AssertionError(f"validate_kernels failed on the card (rc {rc}): {bad}")
    if {name: got[name] for name in want} != want or by_body["attention_headmajor"]["sm90"] != sm90 \
            or any(unreported.values()):
        raise AssertionError(f"validate_kernels launched {got}, expected {want}")
    return out


def ws_cases_step(torch, fa, cfg, launches) -> dict:
    """K3 in bf16 at WS_CASE_DIMS x WS_CASE_ROWS, RoPE on and off, on
    contiguous tensors and on views of one fused projection (3 heads),
    untimed (:func:`kernel_case`: one staging launch with a call where
    ``fa.headmajor_staged``, d % 16 != 0 below 193 and d % 8 != 0 above, so
    none at 200, 232 and 248; a view case calling K3 twice), with the
    counts set to 0 before
    the cases and read after them (``launches["ws_cases"]``): each call
    through the body K3 routes d to, the two-consumer body from 193 to 256
    and the Hopper body below, counted by body name; every case against the
    plain version within kernel_case's bf16 bound (one bf16 ulp of the
    result + 2^-8 max|v| + 1e-5, no looser than the cuda tests'
    ``_card_tolerance``, which allows 2^-7 of the result)."""
    t = time.perf_counter()
    reset_launches(fa)
    cases = []
    for d in WS_CASE_DIMS:
        for N, n_valid in WS_CASE_ROWS:
            B, grid = (2, (16, 16)) if N < 1000 else (1, (30, 40))
            for rope in (False, True):
                for view in (False, "fused"):
                    cases.append(kernel_case(torch, fa, cfg, "attention_headmajor", B, 3, N, d,
                                             grid, torch.bfloat16, rope, n_valid=n_valid,
                                             time_it=False, view=view))
    got = read_launches(fa)
    launches["ws_cases"] = got
    want = {"attention_headmajor": 0, "sm90_ws": 0, "sm90": 0, "wide": 0, "staging": 0}
    for c in cases:
        n = 2 if c["inputs"] != "contiguous" else 1
        want["attention_headmajor"] += n
        want[fa.attention_body("attention_headmajor", torch.bfloat16, c["head_dim"])] += n
        want["staging"] += n * fa.headmajor_staged(torch.bfloat16, c["head_dim"], c["rope"])
    worst = max(cases, key=lambda c: c["max_abs_err"])
    # the two-consumer body's rows read in place: no call stages
    in_place = [c for c in cases if 193 <= c["head_dim"] < 256 and c["head_dim"] % 8 == 0]
    staged_in_place = sum(c["launches"]["staging"] for c in in_place)
    out = {"cases": len(cases), "head_dims": list(WS_CASE_DIMS),
           "in_place_193_255_calls": len(in_place),
           "in_place_193_255_staging_launches": staged_in_place,
           "rows": [list(r) for r in WS_CASE_ROWS], "launches": got, "expected_launches": want,
           "max_abs_err": worst["max_abs_err"],
           "worst": {key: worst[key] for key in ("name", "B", "N", "H", "head_dim", "n_valid",
                                                 "rope", "inputs", "max_abs_err", "tol")},
           "ptxas": sorted({c["ptxas"] for c in cases}), "seconds": time.perf_counter() - t}
    bad = [c for c in cases if not c["ok"] or c["body"] != fa.attention_body(
        "attention_headmajor", torch.bfloat16, c["head_dim"])]
    if bad or {key: got[key] for key in want} != want or staged_in_place:
        raise AssertionError(f"K3's cases at the two-consumer body's set: {bad}; launched {got}, "
                             f"expected {want}; staging at 193-255: {staged_in_place}")
    emit({"phase": "kernel_ws_cases", **out})
    return out


def padded_calls(torch, fa, cfg, runs=None) -> dict:
    """``calls_launches`` at each of ``runs`` (:func:`padded_runs` by
    default), RoPE off and on, keyed (N, d, dtype, rope). Taken in phase 2:
    after phases 8 and 9 the profiler's traces hold no device events on the
    card's machine."""
    return {(N, d, str(dtype), rope): calls_launches(
                torch, fa, cfg, B, H, N, d, (16, 16) if N == 261 else (30, 40), dtype, rope)
            for B, N, H, d, dtype in runs or padded_runs(torch) for rope in (False, True)}


def padded_cases(torch, fa, cfg, calls, runs=None) -> list:
    """K3 at :func:`padded_runs`' head dims, RoPE off and on: each against
    the plain version at d, timed beside the kernel at the width it runs at
    (on tensors padded to it beforehand) and SDPA at d, with the kernels one
    call launches (K3's counter, the counter of the body it ran, and every
    CUDA kernel of a profiler trace of one call: ``calls``, from
    :func:`padded_calls`) and the SM clock. Every bf16 width runs with no
    copy: at a multiple of 16 one kernel a call, two with RoPE (the
    prologue, then K3); at another d two, the staging pass, then K3 (its
    time alone beside: :func:`staging_case`); fp32 at a multiple of 4 too:
    two, the fp32 bodies' prologue, then K3."""
    cases = []
    for B, N, H, d, dtype in runs or padded_runs(torch):
        grid = (16, 16) if N == 261 else (30, 40)
        width = fa.headmajor_width(dtype, d)
        for rope in (False, True):
            case = kernel_case(torch, fa, cfg, "attention_headmajor", B, H, N, d, grid, dtype,
                               rope)
            case["body"] = fa.attention_body("attention_headmajor", dtype, width)
            case["padded_to"] = width
            case.update(calls[(N, d, str(dtype), rope)])
            staged = fa.headmajor_staged(dtype, d, rope)
            if fa.headmajor_in_place(dtype, d, rope):
                want = 2 if case["body"] in fa.TF32_BODIES or staged else 1 + rope
                case["ok"] = case["ok"] and case["kernels_per_call"] == want \
                    and case["body_launches_per_call"] == 1 \
                    and case["staging_launches_per_call"] == staged and not any(
                        COPY_KERNEL.search(name) for name in case["kernel_names"])
            if staged:
                case.update(staging_case(torch, fa, cfg, B, N, H, d, grid, rope))
            case["built_width_ms"] = built_width_ms(torch, fa, cfg, B, H, N, d, grid, dtype, rope)
            case["gpu_clocks"] = gpu_clocks()
            case["phase"] = "kernel_padded"
            emit(case)
            cases.append(case)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K3 at padded widths disagrees with its plain version: {bad}")
    return cases


def wide_odd_cases(torch, fa, cfg) -> list:
    """K3 at WIDE_ODD_CASES' head dims, bf16 and fp32, and at
    WIDE_ODD_FP32_CASES' in fp32, with RoPE tables: each against the plain
    version at d, timed beside its bound and SDPA at d (RoPE applied
    beforehand); the fp32 slices body's cases with its slices, the FLOP its
    repeated scores add and its prologue (:func:`slices_case`)."""
    runs = [(B, N, H, d, None, dtype) for B, N, H, d in WIDE_ODD_CASES
            for dtype in (torch.bfloat16, torch.float32)]
    runs += [(*case, torch.float32) for case in WIDE_ODD_FP32_CASES]
    cases = []
    for B, N, H, d, n_valid, dtype in runs:
        grid = (16, 16) if N == 261 else (30, 40)
        case = kernel_case(torch, fa, cfg, "attention_headmajor", B, H, N, d, grid, dtype,
                           True, n_valid=n_valid)
        case["padded_to"] = fa.headmajor_width(dtype, d) if fa.headmajor_in_place(
            dtype, d, True) else fa.padded_head_dim(d)
        if case["body"] == "sm90_f32_slices":
            case.update(slices_case(torch, fa, cfg, B, N, H, d, n_valid, grid))
        if fa.headmajor_staged(dtype, d, True):
            case.update(staging_case(torch, fa, cfg, B, N, H, d, grid, True))
        case["phase"] = "kernel_wide_odd"
        emit(case)
        cases.append(case)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"K3 at wide or odd head dims disagrees with its plain version: {bad}")
    return cases


SLICES_KEYS = ("slices", "slice_cols", "slice_extra_gflop", "bound_ms_with_slices",
               "prologue_ms", "prologue_norope_ms", "prologue_bound_ms", "prologue_gbps")


def slices_case(torch, fa, cfg, B, N, H, d, n_valid, grid) -> dict:
    """What the fp32 slices body adds to a K3 case at (B, N, H, d): its
    slices of O (``fa.TF32_SLICE_COLS`` columns a block), the FLOP of the
    scores formed once a slice beyond the first (the bound counts them
    once; ``bound_ms_with_slices`` counts them all), and its prologue alone
    (``fa.tf32_prologue``) on inputs of that shape, with the model's tables
    at an even d, timed beside its byte bound (k and v read once, the four
    planes of the scratch written once)."""
    nv = n_valid or N
    slices = -(-d // fa.TF32_SLICE_COLS)
    extra = 2 * B * H * N * nv * d * (slices - 1)
    rng = np.random.default_rng(SEED)
    k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).to("cuda")
            for _ in range(2))
    cos = sin = None
    if d % 2 == 0:
        cos, sin = rope_full(torch, cfg, d, grid, N, "cuda")
    nbytes = 4 * B * H * (2 * nv * d + 4 * fa.tf32_scratch_keys(nv) * fa.tf32_width(d))
    ms = time_ms(torch, lambda: fa.tf32_prologue(k, v, n_valid, cos, sin))
    return {"slices": slices, "slice_cols": fa.TF32_SLICE_COLS, "slice_extra_gflop": extra / 1e9,
            "bound_ms_with_slices": 1e3 * (4 * B * H * N * nv * d + extra) / PEAK_F32_ACCURATE_FLOPS,
            "prologue_ms": ms,
            "prologue_norope_ms": time_ms(torch, lambda: fa.tf32_prologue(k, v, n_valid)),
            "prologue_bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "prologue_gbps": nbytes / ms / 1e6}


STAGING_KEYS = ("staging_ms", "staging_norope_ms", "staging_plain_ms", "staging_bound_ms",
                "staging_gbps", "staging_bit_equal")


def staging_bytes(B, N, H, d, w, rope) -> int:
    """What bf16's staging pass must move at (B, N, H, d): q, k and v read
    once, their scratch rows of w elements (``fa.stage_width``) written
    once, and with RoPE the (N, d) fp32 tables read once."""
    return 2 * 3 * B * H * N * (d + w) + (2 * N * d * 4 if rope else 0)


def staging_case(torch, fa, cfg, B, N, H, d, grid, rope) -> dict:
    """bf16's staging pass alone (``fa.bf16_stage``) at (B, N, H, d) on
    head-major views of one fused projection, with the case's tables where
    ``rope``: bit for bit its plain version, timed beside its byte bound
    and the plain version (no one PyTorch call stages three tensors)."""
    rng = np.random.default_rng(SEED)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(
        "cuda", torch.bfloat16)
    q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2)
               for j in range(3))
    cos, sin = head_tables(torch, cfg, d, grid, N) if rope else (None, None)
    scale = d ** -0.5
    got = fa.bf16_stage(q, k, v, scale, None, cos, sin)
    equal = bool(torch.equal(got, fa.bf16_stage_reference(q, k, v, scale, None, cos, sin)))
    if not equal:
        raise AssertionError(f"the staging pass at {(B, N, H, d)} leaves its plain version")
    ms = time_ms(torch, lambda: fa.bf16_stage(q, k, v, scale, None, cos, sin))
    nbytes = staging_bytes(B, N, H, d, fa.stage_width(d), rope)
    return {"staging_ms": ms,
            "staging_norope_ms": time_ms(torch, lambda: fa.bf16_stage(q, k, v, scale)),
            "staging_plain_ms": time_ms(torch, lambda: fa.bf16_stage_reference(
                q, k, v, scale, None, cos, sin)),
            "staging_bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "staging_gbps": nbytes / ms / 1e6,
            "staging_bit_equal": equal}


def calls_launches(torch, fa, cfg, B, H, N, d, grid, dtype, rope) -> dict:
    """K3's launches in one call at d (its counter, the counter of the body
    it runs there: the Hopper body's, the fp32 bodies' or the wide body's,
    and the staging pass's) and the CUDA kernels the call ran (a profiler
    trace), by name."""
    rng = np.random.default_rng(SEED)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).to("cuda", dtype)
               for _ in range(3))
    cos, sin = head_tables(torch, cfg, d, grid, N) if rope else (None, None)
    body = fa.attention_body("attention_headmajor", dtype, fa.headmajor_width(dtype, d))
    before = read_launches(fa)
    fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin)
    after = read_launches(fa)
    names = trace_kernels(torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin),
                          traces=2)
    return {"k3_launches_per_call": after["attention_headmajor"] - before["attention_headmajor"],
            "body_launches_per_call": after[body] - before[body],
            "staging_launches_per_call": after["staging"] - before["staging"],
            "kernels_per_call": len(names), "kernel_names": [name[:120] for name in names]}


def built_width_ms(torch, fa, cfg, B, H, N, d, grid, dtype, rope) -> float:
    """K3's time at the width it runs ``d`` at, on tensors padded to it
    beforehand (no pad or slice in the timed call)."""
    width = fa.headmajor_width(dtype, d)
    rng = np.random.default_rng(SEED)
    q, k, v = (fa.pad_head_dim(torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32))
                               .to("cuda", dtype), width, rope) for _ in range(3))
    cos = sin = None
    if rope:
        cos, sin = (fa.pad_head_dim(t, width, True) for t in head_tables(torch, cfg, d, grid, N))
    return time_ms(torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin))


def attention_map_step(torch, fa, cfg, params, launches) -> dict:
    """``cls_attention_map`` at ``cfg``'s full width and depth on MAP_FRAMES
    frames of 256x256 in bf16 on the card: K1 once a block but the last,
    each launch through the Hopper body; the map against the CPU fp32 run."""
    from cbas_tpu_torch.models.convert import vit_params_from_numpy
    from cbas_tpu_torch.models.vit import cls_attention_map

    gained = {k: v * MAP_QK_GAIN if k.endswith(("q_proj.weight", "k_proj.weight")) else v
              for k, v in params.items()}
    planes = np.random.default_rng(SEED + 10).integers(0, 256, (MAP_FRAMES, 256, 256), np.uint8)
    x = np.repeat((planes / 255.0).astype(np.float32)[:, None], 3, axis=1)
    card_params = vit_params_from_numpy(gained, cfg, "cuda", torch.bfloat16)
    pixels = torch.from_numpy(x).to("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches(fa)
    got = cls_attention_map(card_params, pixels, cfg)
    torch.cuda.synchronize()
    launches["cls_attention_map"] = read_launches(fa)
    want_launches = check_launches("cls_attention_map", launches["cls_attention_map"],
                                   "attention_fat", cfg.num_layers - 1, 1, sm90=True,
                                   ln_per=ln_per_forward(cfg.num_layers) - 2, cls_blocks=0)
    ms = time_ms(torch, lambda: cls_attention_map(card_params, pixels, cfg), iters=5, warmup=1)
    t = time.perf_counter()
    ref = cls_attention_map(vit_params_from_numpy(gained, cfg), torch.from_numpy(x), cfg).numpy()
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
    and equal to an in-process ``encode_file`` on ``device``, both at
    FLEET_THREADS intra-op threads. (``device`` is "cpu" only in the CPU
    test of this function.)"""
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
        env = fleet_env(os.path.dirname(os.path.abspath(__file__)))
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
        with fleet_threads(torch) as pinned:
            rows_of = {video: _in_process_rows(encode_file, enc, d, video) for video in videos}
        for video in videos:
            h5 = video.replace(".mp4", "_cls.h5")
            if not hdf5_store.is_stamp_valid(h5, ident):
                raise AssertionError(f"encode_fleet: {h5} is not stamped by {ident}")
            with h5py.File(h5, "r") as f:
                fleet_rows = f["cls"][:]
            rows = rows_of[video]
            if rows.shape != fleet_rows.shape or not np.array_equal(rows, fleet_rows):
                by_row = (np.abs(rows.astype(np.float32) - fleet_rows).max(axis=1)
                          if rows.shape == fleet_rows.shape else None)
                raise AssertionError(
                    f"encode_fleet: {h5} differs from the in-process encode: shapes "
                    f"{rows.shape} / {fleet_rows.shape}, rows that differ "
                    f"{None if by_row is None else np.flatnonzero(by_row)[:20].tolist()}, "
                    f"by up to {None if by_row is None else float(by_row.max())}, "
                    f"{FLEET_THREADS} intra-op threads each side, in-process settings "
                    f"{pinned}, the workers' oneDNN {onednn_kernels(proc.stdout)}, "
                    f"fleet lines {lines}")
            max_diff = max(max_diff, float(np.abs(rows.astype(np.float32) - fleet_rows).max()))
    return {"clips": FLEET_CLIPS, "frames": FLEET_FRAMES, "workers": 1, "device": device,
            "dtype": dtype, "wall_s": fleet_s, "summary": lines[-1],
            "max_abs_diff_vs_in_process": max_diff, "in_process": pinned, "ok": True}


# oneDNN's verbose level in the fleet's workers: a line on their standard
# output for each primitive they create (one write a line, so the lines and
# the fleet's JSON records do not cut each other), naming the CPU ISA and each
# matmul's implementation (onednn_kernels).
FLEET_ONEDNN_VERBOSE = "profile_create"


def fleet_env(root) -> dict:
    """The environment of ``encode_fleet``'s workers: this process's without
    PYTHONPATH, the repository at ``root`` on it, FLEET_THREADS intra-op
    threads for OpenMP and MKL and both libraries' dynamic teams off, so no
    worker picks a smaller team (and another summation order) under load;
    and oneDNN's verbose lines on (FLEET_ONEDNN_VERBOSE), so a run that
    differs from an in-process encode can say which kernels the workers
    ran."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    env.update(OMP_NUM_THREADS=str(FLEET_THREADS), MKL_NUM_THREADS=str(FLEET_THREADS),
               MKL_DYNAMIC="FALSE", OMP_DYNAMIC="FALSE", ONEDNN_VERBOSE=FLEET_ONEDNN_VERBOSE)
    return env


def onednn_kernels(text: str) -> dict:
    """What oneDNN's verbose lines in ``text`` name: the CPU ISA it
    dispatches to ("isa") and each matmul implementation it created
    ("matmul": AMX and AVX-512 kernels round bf16 products differently)."""
    isa, matmul = set(), set()
    for line in text.splitlines():
        if not line.startswith("onednn_verbose"):
            continue
        fields = line.split(",")
        if "isa:" in line:
            isa.add(line.split("isa:", 1)[1])
        elif "primitive" in fields and "matmul" in fields[:-1]:
            matmul.add(fields[fields.index("matmul") + 1])
    return {"isa": sorted(isa), "matmul": sorted(matmul)}


def _omp_dynamic():
    """(omp_get_dynamic, omp_set_dynamic, where) of the OpenMP runtime torch
    runs its intra-op threads on: the one torch ships in its lib directory
    (libgomp, libiomp5 or libomp), opened by path, which is the copy torch
    has loaded (a library loaded with local symbols is invisible to a lookup
    in the process's global ones), else the process's global symbols; None
    where neither exports them. ``where`` is the library's path, or
    "global"."""
    import ctypes
    import glob

    import torch

    lib_dir = os.path.join(os.path.dirname(torch.__file__), "lib")
    paths = [p for pattern in ("libgomp*.so*", "libiomp5*.so*", "libomp*.so*")
             for p in sorted(glob.glob(os.path.join(lib_dir, pattern)))]
    for path in paths + [None]:
        try:
            lib = ctypes.CDLL(path)
            get, put = lib.omp_get_dynamic, lib.omp_set_dynamic
        except (OSError, AttributeError):
            continue
        get.restype, put.argtypes = ctypes.c_int, [ctypes.c_int]
        return get, put, path or "global"
    return None


@contextlib.contextmanager
def fleet_threads(torch):
    """This process's encodes held to the workers' settings (``fleet_env``):
    FLEET_THREADS intra-op threads, MKL_DYNAMIC and OMP_DYNAMIC "FALSE" in
    the environment (read only where MKL or OpenMP starts after this: both
    have started in a process that has run torch on the CPU, so there they
    change nothing), and OpenMP's dynamic team off in this thread through
    ``omp_set_dynamic`` (:func:`_omp_dynamic`); all restored after. Yields
    what was pinned, for a failure's message and the fleet step's record:
    {"threads", "omp_runtime" (the library, or None where no runtime was
    found and the dynamic team was left as it was), "omp_dynamic_before",
    "omp_dynamic_inside" (omp_get_dynamic() before and inside the block)}."""
    threads = torch.get_num_threads()
    omp = _omp_dynamic()
    dynamic = omp[0]() if omp else None
    with contextlib.ExitStack() as stack:
        for name in ("MKL_DYNAMIC", "OMP_DYNAMIC"):
            stack.enter_context(env_var(name, "FALSE"))
        torch.set_num_threads(FLEET_THREADS)
        if omp:
            omp[1](0)
        try:
            yield {"threads": torch.get_num_threads(), "omp_runtime": omp[2] if omp else None,
                   "omp_dynamic_before": dynamic, "omp_dynamic_inside": omp[0]() if omp else None}
        finally:
            torch.set_num_threads(threads)
            if omp:
                omp[1](dynamic)


def _in_process_rows(encode_file, enc, d, video):
    """``encode_file`` of a copy of ``video`` under ``d``, in this process:
    the H5's CLS rows."""
    import shutil

    import h5py

    inproc = os.path.join(d, "inproc", os.path.basename(video))
    os.makedirs(os.path.dirname(inproc), exist_ok=True)
    shutil.copyfile(video, inproc)
    with h5py.File(encode_file(enc, inproc), "r") as f:
        return f["cls"][:]


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


def mesh_launches_check(route, got, kernel, n, ln_n, device, shards):
    """``kernel`` launched ``n`` times and no other attention kernel, each
    through the Hopper body, the LayerNorm kernel ``ln_n`` times and one
    CLS block a shard (on the CPU the plain versions run and nothing is
    counted)."""
    if device != "cuda":
        return None
    return check_launches(route, got, kernel, n, 1, sm90=True, ln_per=ln_n, cls_blocks=shards)


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
                                       (cfg.num_layers - 1) * d * m,
                                       ln_per_forward(cfg.num_layers) * d * m, device, d * m)
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
        for name in (*KERNELS, LN_KERNEL):
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
                                       (cfg.num_layers - 1) * MESH_7B_MODEL,
                                       ln_per_forward(cfg.num_layers) * MESH_7B_MODEL, device,
                                       MESH_7B_MODEL)
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
    for name in (*KERNELS, LN_KERNEL):
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
