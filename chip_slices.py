#!/usr/bin/env python3
"""Where the fp32 slices body's time goes, on one CUDA card.

    python3 chip_slices.py        # from the repository root; about 3 minutes

K3 in fp32 above 256 runs ``csrc/attention_sm90_tf32_slices.cuh`` (after its
prologue, ``split_kv_wide``). This script builds K3's library
(``csrc/attention_headmajor.cu``) as the checkout has it, and again from
copies of ``csrc/`` in which that header is edited (``VARIANTS``, under
``cbas_tpu_torch/_build/slices_variants/``, the package's nvcc flags, all
built at once), then times each through ``ops/flash_attention.py``'s
``fused_attention`` with its library swapped in, at phase 10's fp32 shapes
(``SHAPES``) without RoPE, in turns: body, variant, variant, body, 2 reads
each (CUDA events over 20 launches after 3 warm-up, ``chip_smoke.time_ms``):

- ``slices_256``: 256-column slices (two O chunks a warpgroup, the p.V
  buffers of 64 accumulator registers), so the scores are formed twice at
  d 257-512: the design weighed against the 384-column slices;
- ``no_qk``: q.k^T's wgmma left out (the scores zero; Q's loads and splits,
  the ring, the commits and waits kept);
- ``no_pv``: p.V's wgmma left out (its tile accumulators zero);
- ``no_exchange``: the two warpgroups' partial scores do not meet (each
  keeps its own).

The last three compute a wrong function: each prices a stage by what its
removal saves. Beside them, per shape: the body with RoPE, its prologue
alone (``fa.tf32_prologue``), SDPA in fp32 on the same tensors, the bound
(``chip_smoke.attention_bound``) and the SM clock after the reads. Each
variant's registers and spills come from its ``-Xptxas -v`` report. Prints
the card's name and power limit, then one JSON line a shape. Needs one GPU;
imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SHAPES = ((8, 261, 16, 320), (4, 1205, 8, 384))  # (B, N, H, d), as phase 10 times them
HEADER = "attention_sm90_tf32_slices.cuh"
QK_MMA = """        wgmma_rs<kKeys>(s_small, a_lo[kk], sw128_desc(sk, 16, 1024), acc);
        wgmma_rs<kKeys>(s_small, a_hi[kk], sw128_desc(sk + kPlaneBytes, 16, 1024), 1);
        wgmma_rs<kKeys>(s, a_hi[kk], sw128_desc(sk, 16, 1024), acc);
"""
PV_MMA = """#pragma unroll
        for (int j = 0; j < kPSteps; ++j) {
          wgmma_rs<kChunkCols>(acc, plo[j], sw128_desc(v_hi + 32 * j, 16, 1024), j > 0);
          wgmma_rs<kChunkCols>(acc, phi[j], sw128_desc(v_lo + 32 * j, 16, 1024), 1);
        }
#pragma unroll
        for (int j = 0; j < kPSteps; ++j)
          wgmma_rs<kChunkCols>(acc, phi[j], sw128_desc(v_hi + 32 * j, 16, 1024), 1);
"""
TILE_START = """    fence_regs(s);
    fence_regs(s_small);
    uint32_t k_hi = 0;
"""
EXCHANGE_START = "    if (kt > 0) mbar_wait(partial_free(wg), (kt - 1) & 1);\n"
EXCHANGE_END = "    if (lane == 0) mbar_arrive(partial_free(1 - wg));\n"
# A stage's operands kept live, so that leaving its wgmma out drops no other work.
KEEP_QK = ('        asm volatile("" :: "r"(a_lo[kk][0]), "r"(a_lo[kk][1]), "r"(a_lo[kk][2]), '
           '"r"(a_lo[kk][3]), "r"(a_hi[kk][0]), "r"(a_hi[kk][1]), "r"(a_hi[kk][2]), '
           '"r"(a_hi[kk][3]), "r"(sk));\n')
KEEP_PV = ('#pragma unroll\n        for (int j = 0; j < kPSteps; ++j) asm volatile("" :: '
           '"r"(phi[j][0]), "r"(phi[j][1]), "r"(phi[j][2]), "r"(phi[j][3]), "r"(plo[j][0]), '
           '"r"(plo[j][1]), "r"(plo[j][2]), "r"(plo[j][3]), "r"(v_hi), "r"(v_lo));\n'
           '#pragma unroll\n        for (int i = 0; i < 32; ++i) acc[i] = 0.f;\n')


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"chip_slices: {HEADER} no longer holds {old.strip()[:60]!r}")
    return text.replace(old, new)


def _no_exchange(text: str) -> str:
    start = text.index(EXCHANGE_START)
    end = text.index(EXCHANGE_END) + len(EXCHANGE_END)
    return text[:start] + text[end:]


VARIANTS = {
    "slices_256": lambda t: _edit(t, "constexpr int kOutChunks = 3;", "constexpr int kOutChunks = 2;"),
    "no_qk": lambda t: _edit(_edit(t, QK_MMA, KEEP_QK), TILE_START, TILE_START.replace(
        "    uint32_t k_hi = 0;\n",
        "    for (int i = 0; i < kS; ++i) s[i] = s_small[i] = 0.f;\n    uint32_t k_hi = 0;\n")),
    "no_pv": lambda t: _edit(t, PV_MMA, KEEP_PV),
    "no_exchange": _no_exchange,
}


def build_variants(cuda_mod, fa) -> dict:
    """Each VARIANTS entry built into a library of its own, in parallel:
    {name: (the C entry bound like fa._kernel's, its slices body's ptxas)}."""
    src = cuda_mod.SRC_DIR
    root = cuda_mod.BUILD_DIR / "slices_variants"
    shutil.rmtree(root, ignore_errors=True)

    def one(name):
        d = root / name
        shutil.copytree(src, d)
        (d / HEADER).write_text(VARIANTS[name]((src / HEADER).read_text()))
        lib = d / "attention_headmajor.so"
        proc = subprocess.run([cuda_mod._nvcc(), *cuda_mod.NVCC_FLAGS, "-o", str(lib),
                               str(d / "attention_headmajor.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"chip_slices: {name} failed to build:\n{proc.stderr[-4000:]}")
        return name, lib, slices_ptxas(proc.stdout + proc.stderr)

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(one, VARIANTS))
    out = {}
    for name, lib, ptxas in built:
        fn = ctypes.CDLL(str(lib)).cbas_attention_headmajor
        fn.restype = fa._kernel("attention_headmajor").restype
        fn.argtypes = fa._kernel("attention_headmajor").argtypes
        out[name] = (fn, ptxas)
    return out


def slices_ptxas(log: str) -> dict:
    """Registers and spill bytes of the slices body's kernels in a
    ``-Xptxas -v`` log, by Q's mode."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S*attention_tf32_slicesILb([01])E\S*)'"
                         r".*?(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                         r"Used (\d+) registers", log, re.S):
        out["resident Q" if m.group(2) == "1" else "streamed Q"] = (
            f"{m.group(5)} regs, {m.group(3)}/{m.group(4)} spill"
            + (", wgmma serialized" if re.search(rf"C7518[^\n]*{re.escape(m.group(1))}", log)
               else ""))
    return out


def main() -> int:
    import torch

    import chip_smoke
    from cbas_tpu_torch.models.vit import PRESETS
    from cbas_tpu_torch.ops import _cuda
    from cbas_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_slices: no CUDA device is visible", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    body_lib = _cuda.build("attention_headmajor")
    body_ptxas = slices_ptxas(body_lib.with_suffix(".log").read_text())
    body = fa._kernel("attention_headmajor")
    variants = build_variants(_cuda, fa)
    rng = np.random.default_rng(chip_smoke.SEED)
    try:
        for B, N, H, d in SHAPES:
            q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).cuda()
                       for _ in range(3))
            scale = d ** -0.5

            def timed(fn):
                fa._kernel = lambda name, fn=fn: fn
                return chip_smoke.time_ms(torch, lambda: fa.fused_attention(q, k, v, scale))

            want = fa.attention_headmajor_reference(q, k, v, scale)
            fa._kernel = lambda name: body
            err = float((fa.fused_attention(q, k, v, scale) - want).abs().max())
            line = {"shape": [B, N, H, d], "body_max_abs_err": err, "body_ptxas": body_ptxas}
            for name, (fn, ptxas) in variants.items():
                reads = {"body": [], name: []}
                for turn in ("body", name, name, "body"):
                    for _ in range(2):
                        reads[turn].append(timed(body if turn == "body" else fn))
                line[name] = {"ms": statistics.median(reads[name]),
                              "body_ms": statistics.median(reads["body"]),
                              "reads": reads, "ptxas": ptxas}
            fa._kernel = lambda name: body
            cos, sin = chip_smoke.rope_full(torch, PRESETS["dinov3-vitb16"], d,
                                            (16, 16) if N == 261 else (30, 40), N, "cuda")
            line["body_rope_ms"] = chip_smoke.time_ms(
                torch, lambda: fa.fused_attention(q, k, v, scale, None, cos, sin))
            line["prologue_ms"] = chip_smoke.time_ms(torch, lambda: fa.tf32_prologue(k, v))
            from torch.nn.functional import scaled_dot_product_attention as sdpa
            line["sdpa_ms"] = chip_smoke.time_ms(torch, lambda: sdpa(q, k, v, scale=scale))
            line.update(chip_smoke.attention_bound(B, N, H, d, N, False, fp32=True))
            line["gpu_clocks"] = chip_smoke.gpu_clocks()
            line["card"] = card
            print(json.dumps(line), flush=True)
            del q, k, v
    finally:
        fa._kernel = lambda name: body
    return 0


if __name__ == "__main__":
    sys.exit(main())
