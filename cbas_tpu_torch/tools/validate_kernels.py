"""On-device kernel validation: fused attention vs unfused vs an fp64 oracle.

The CPU test suite exercises the CUDA kernels only through their plain
PyTorch versions (a CUDA kernel has no CPU mode), so this diagnostic proves
the *compiled* kernels' numerics on the CUDA device — run it after a
PyTorch/CUDA upgrade or a kernel change:

    python -m cbas_tpu_torch.tools.validate_kernels [--device cuda|cpu]

Exit code 0 = every geometry passes; without a CUDA device (and no
``--device cpu``) it raises naming CUDA. Expected envelopes on the card:
every geometry here has heads of 64 or 128, where the fp32 kernels run
the fp32 Hopper body (``csrc/attention_sm90_tf32.cuh``): each fp32 product
as three TF32 products on the tensor cores, summed in fp32, so against
fp64 they sit where the CPU does, not at a TPU's bf16-decomposed fp32 dot.
On an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, the largest fp32
error at GEOMETRIES plus (2, 32, 261, 128, True) was 7.5e-7 (unfused
fp32: 7.1e-7; the FMA body before it: 8.0e-7), held to ``CARD_TOL_F32`` =
5e-6; the CPU keeps its 2e-5. The production bf16 path agreed with
unfused bf16 to 1.2e-2 there (bound 3e-2).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cbas_tpu_torch.tools._device import require_device

GEOMETRIES = [
    # (B, H, N, d, rope) — 480p ViT-B, 256x256 ViT-B, ViT-L head shape
    (4, 12, 1205, 64, True),
    (4, 12, 261, 64, False),
    (2, 16, 325, 64, True),
]

# fp32 kernels against fp64 on the card: six times the largest error
# measured there (module docstring).
CARD_TOL_F32 = 5e-6


def _oracle(q, k, v, scale):
    # matmul, not einsum: einsum runs these batched products in numpy's own
    # loops, matmul through BLAS (4.5 GFLOP at the 480p geometry)
    s = np.matmul(q.astype(np.float64), k.astype(np.float64).swapaxes(-1, -2)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.matmul(p, v.astype(np.float64))


def main(geometries=None, device="cuda", records=None) -> int:
    """Run the validation sweep; ``geometries`` overrides the production
    list (the CPU test suite passes tiny shapes to smoke the harness).
    ``device`` is where the kernels run ("cpu": their plain versions).
    Each check is appended to ``records``, where it is a list, as
    {"check", "err", "tol", "ok"}."""
    from cbas_tpu_torch.ops.flash_attention import (
        fused_attention,
        fused_attention_packed,
        reference_attention,
    )

    dev = require_device(device)
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'})")
    # fp32-vs-fp64 envelope: fp32 roundoff through softmax (CPU), and the
    # card's measured envelope (CARD_TOL_F32).
    tol_f32 = 2e-5 if dev.type == "cpu" else CARD_TOL_F32
    rng = np.random.default_rng(0)
    failures = 0

    def on(a):  # numpy -> a tensor on the device
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check(label, err, tol):
        ok = bool(err < tol)
        if records is not None:
            records.append({"check": label, "err": float(err), "tol": tol, "ok": ok})
        return ok

    for B, H, N, d, rope in (GEOMETRIES if geometries is None else geometries):
        scale = d ** -0.5
        q, k, v = (rng.normal(size=(B, H, N, d)).astype(np.float32) for _ in range(3))
        if rope:
            cos = rng.uniform(-1, 1, (N, d)).astype(np.float32)
            sin = rng.uniform(-1, 1, (N, d)).astype(np.float32)

            def rot(t):
                return np.concatenate([-t[..., d // 2 :], t[..., : d // 2]], -1)

            qq, kk = q * cos + rot(q) * sin, k * cos + rot(k) * sin
            got = fused_attention(
                on(q), on(k), on(v), scale,
                rope_cos=on(cos), rope_sin=on(sin),
            )
        else:
            qq, kk = q, k
            got = fused_attention(on(q), on(k), on(v), scale)
        want = _oracle(qq, kk, v, scale)
        unfused = reference_attention(on(qq), on(kk), on(v), scale)
        err_f = np.abs(got.double().cpu().numpy() - want).max()
        err_x = np.abs(unfused.double().cpu().numpy() - want).max()
        ok = check(f"B{B} H{H} N{N} d{d} rope={rope}: fused vs fp64", err_f, tol_f32)
        failures += not ok
        print(
            f"B{B} H{H} N{N} d{d} rope={rope}: fused vs fp64 {err_f:.2e} "
            f"(unfused {err_x:.2e}) {'ok' if ok else 'FAIL'}"
        )

        if d == 64 and H % 2 == 0:
            # The production head-PAIR packed layout (what _attention emits
            # for d=64 backbones) — validate the compiled packed kernel too.
            def pack(t):
                return np.ascontiguousarray(
                    t.reshape(B, H // 2, 2, N, d).transpose(0, 1, 3, 2, 4)
                ).reshape(B, H // 2, N, 2 * d)

            got_p = fused_attention_packed(
                on(pack(q)), on(pack(k)), on(pack(v)),
                scale,
                rope_cos=on(cos) if rope else None,
                rope_sin=on(sin) if rope else None,
            )
            unpacked = (
                got_p.double().cpu().numpy()
                .reshape(B, H // 2, N, 2, d)
                .transpose(0, 1, 3, 2, 4)
                .reshape(B, H, N, d)
            )
            err_p = np.abs(unpacked - want).max()
            ok = check(f"B{B} H{H} N{N} d{d} rope={rope}: packed vs fp64", err_p, tol_f32)
            failures += not ok
            print(
                f"B{B} H{H} N{N} d{d} rope={rope}: packed vs fp64 {err_p:.2e} "
                f"{'ok' if ok else 'FAIL'}"
            )

            # The FLAT row-major layout (r4 production default for d=64):
            # (B, N, H*d), head pairs on 128-lane bands.
            from cbas_tpu_torch.ops.flash_attention import fused_attention_fat

            flat = lambda t: np.ascontiguousarray(  # noqa: E731
                t.transpose(0, 2, 1, 3)
            ).reshape(B, N, H * d)
            got_f = fused_attention_fat(
                on(flat(q)), on(flat(k)), on(flat(v)),
                scale,
                rope_cos=on(cos) if rope else None,
                rope_sin=on(sin) if rope else None,
            )
            if got_f is not None:
                unflat = (
                    got_f.double().cpu().numpy()
                    .reshape(B, N, H, d)
                    .transpose(0, 2, 1, 3)
                )
                err_ff = np.abs(unflat - want).max()
                ok = check(f"B{B} H{H} N{N} d{d} rope={rope}: fat vs fp64", err_ff, tol_f32)
                failures += not ok
                print(
                    f"B{B} H{H} N{N} d{d} rope={rope}: fat vs fp64 {err_ff:.2e} "
                    f"{'ok' if ok else 'FAIL'}"
                )

            # The three kernels on views of one fused (B, N, 3*H*d) q|k|v
            # projection, the model's operands: K1 on its column blocks, K2
            # and K3 on their head-pair and head-major views.
            qkv = on(np.concatenate([flat(q), flat(k), flat(v)], -1))
            cols = [qkv[..., j * H * d:(j + 1) * H * d] for j in range(3)]
            tables = {"rope_cos": on(cos), "rope_sin": on(sin)} if rope else {}
            fused_views = {
                "fat": fused_attention_fat(*cols, scale, **tables).reshape(B, N, H, d)
                .transpose(1, 2),
                "packed": fused_attention_packed(
                    *(c.view(B, N, H // 2, 2 * d).transpose(1, 2) for c in cols), scale, **tables)
                .reshape(B, H // 2, N, 2, d).transpose(2, 3).reshape(B, H, N, d),
                "head-major": fused_attention(
                    *(c.view(B, N, H, d).transpose(1, 2) for c in cols), scale, **tables),
            }
            for name, got_v in fused_views.items():
                err_v = np.abs(got_v.double().cpu().numpy() - want).max()
                label = f"B{B} H{H} N{N} d{d} rope={rope}: {name} on fused q|k|v views vs fp64"
                ok = check(label, err_v, tol_f32)
                failures += not ok
                print(f"{label} {err_v:.2e} {'ok' if ok else 'FAIL'}")

    # Production bf16 path vs unfused bf16 (480p ViT-B shape, or the last
    # override geometry when the test suite passes tiny shapes).
    bB, bH, bN, bd = (2, 12, 1205, 64) if geometries is None else geometries[-1][:4]
    q, k, v = (
        on(rng.normal(size=(bB, bH, bN, bd)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(3)
    )
    err = float(
        torch.max(
            torch.abs(
                fused_attention(q, k, v, bd ** -0.5).float()
                - reference_attention(q, k, v, bd ** -0.5).float()
            )
        )
    )
    ok = check("bf16 production path vs unfused", err, 3e-2)
    failures += not ok
    print(f"bf16 production path vs unfused: {err:.2e} {'ok' if ok else 'FAIL'}")

    # Single-pass bf16 LayerNorm vs the exact two-pass form on rows spanning
    # the outlier-activation regimes pretrained DINOv2/v3 backbones produce:
    # sparse massive dims (variance-dominant — the safe direction for
    # E[x^2]-mean^2) and moderate uniform offsets (r4 advisor finding; full
    # characterization in models/vit.py _ln and
    # tests/test_vit_parity.py::test_layernorm_single_pass_outlier_parity).
    from cbas_tpu_torch.models.vit import _ln

    D = 768
    sparse = rng.standard_normal((16, D))
    for i in range(16):
        sparse[i, rng.integers(0, D, 4)] = 1000.0 * (1 - 2 * (i % 2))
    rows = np.concatenate(
        [
            rng.standard_normal((16, D)),
            sparse,
            30.0 + rng.standard_normal((16, D)),
            -100.0 + 2.0 * rng.standard_normal((16, D)),
        ]
    )
    xb = on(rows.astype(np.float32)).to(torch.bfloat16)
    p = {
        "ln.weight": torch.ones((D,), dtype=torch.float32, device=dev),
        "ln.bias": torch.zeros((D,), dtype=torch.float32, device=dev),
    }
    got = _ln(p, "ln", xb, 1e-6).double().cpu().numpy()
    xq = xb.double().cpu().numpy()
    ref = (xq - xq.mean(-1, keepdims=True)) / np.sqrt(xq.var(-1, keepdims=True) + 1e-6)
    ref = torch.from_numpy(ref.astype(np.float32)).to(torch.bfloat16).double().numpy()
    err_ln = np.abs(got - ref).max()
    ok = check("single-pass bf16 LayerNorm (outlier rows) vs two-pass", err_ln, 6e-2)
    failures += not ok  # ~2 bf16 output ulp at |y| <= 5
    print(f"single-pass bf16 LayerNorm (outlier rows) vs two-pass: {err_ln:.2e} {'ok' if ok else 'FAIL'}")

    # The kernel's two-pass form (CBAS_LN_TWO_PASS) on the same rows against
    # the float64 LayerNorm: one bf16 ulp of the oracle (half for the output's
    # rounding) plus 1e-4 for the fp32 mean of the rows offset by 100. The
    # error is printed as a fraction of that bound.
    from cbas_tpu_torch.ops.layernorm import layernorm

    exact = (xq - xq.mean(-1, keepdims=True)) / np.sqrt(xq.var(-1, keepdims=True) + 1e-6)
    two = layernorm(xb, p["ln.weight"], p["ln.bias"], 1e-6, two_pass=True).double().cpu().numpy()
    bound = np.exp2(np.floor(np.log2(np.maximum(np.abs(exact), 2.0 ** -126))) - 7) + 1e-4
    err_two = (np.abs(two - exact) / bound).max()
    ok = check("two-pass bf16 LayerNorm (outlier rows) vs float64, over 1 bf16 ulp + 1e-4",
               err_two, 1.0)
    failures += not ok
    print(f"two-pass bf16 LayerNorm (outlier rows) vs float64: {err_two:.2f} of its bound "
          f"{'ok' if ok else 'FAIL'}")
    return 1 if failures else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernels run (default: cuda; cpu runs their plain versions)")
    sys.exit(main(device=ap.parse_args().device))
