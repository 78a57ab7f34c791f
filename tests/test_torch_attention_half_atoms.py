"""K3's bf16 bodies at the widths between their builds, on the CPU.

The bf16 Hopper bodies are built at every multiple of 32 from 64 to 256:
the one-warpgroup body (``csrc/attention_sm90.cuh``) at 64, 96, 128, 160 and
192, the two-consumer body (``csrc/attention_sm90_ws.cuh``) at 224 and 256.
A head of width d runs at the next of them, so its products run at d
rounded up to 32 columns, not 64: at 96, 160 and 224 the last 32 columns of
O are one n = 32 product over V's last 32 columns in a box of their own
(64-byte swizzle), and O is written by 16-byte stores. The
two-consumer body reads every d % 8 == 0 in place (rows off 32 bytes on
maps at d, O at 256 by TMA stores on its map at d); only a d % 8 != 0 goes through the staging
launch there, and below 193 every d % 16 != 0, as before.

Here: the route of every d from 1 to 512 in both dtypes (body, built
width, staged or not), the C sources' widths and row units against the
Python mirrors, and the plain K3 (the wrapper on CPU tensors) against the
JAX package's kernel (``cbas_tpu/ops/flash_attention.py::_attn_kernel``,
Pallas interpret mode) at d 96, 160, 200, 224, 232 and 248, N 261 and 1205
cut to one image of two heads, NaN in the dead K/V rows, RoPE on and off.
The card tests of these widths are in ``test_torch_attention_bf16_widths.py``.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32
CSRC = pathlib.Path(fa.__file__).resolve().parent.parent / "csrc"


def _bf16_route(d):
    """(body, width, staged) of a bf16 K3 call at d, by the rule written out:
    up to 192 the one-warpgroup body at d rounded up to 32 (64 at least),
    staged off the multiples of 16; 193-256 the two-consumer body at 224 or
    256, staged off the multiples of 8; above, the wide body at d."""
    if d > 256:
        return "wide", d, None
    width = max(64, -(-d // 32) * 32)
    if d <= 192:
        return "sm90", width, d % 16 != 0
    return "sm90_ws", width, d % 8 != 0


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_every_width_routes_to_its_body_width_and_form(dtype):
    """d 1-512: the body ``attention_body`` names, the width
    ``headmajor_width`` gives (``launches_headmajor_by_dim``'s key) and
    whether ``headmajor_staged`` stages, with RoPE tables and without; fp32
    keeps its bodies at 64, 128, 192 and 256 and never stages."""
    for d in range(1, 513):
        width = fa.headmajor_width(dtype, d)
        body = fa.attention_body("attention_headmajor", dtype, width)
        assert body == fa.attention_body("attention_headmajor", dtype, d), d
        if dtype == BF16:
            want_body, want_width, want_staged = _bf16_route(d)
            assert (body, width) == (want_body, want_width), d
            for rope in (False, True):
                staged = want_staged if d <= 256 else rope and d % 2 == 1
                assert fa.headmajor_staged(dtype, d, rope) == staged, (d, rope)
        else:
            assert width == (d if d > 256 else next(w for w in (64, 128, 192, 256) if w >= d))
            assert body == ("sm90_f32" if d <= 128 else "sm90_f32_wide" if d <= 256
                            else "sm90_f32_slices"), d
            assert not fa.headmajor_staged(dtype, d, True)


@pytest.mark.parametrize("d,width,staged", [(65, 96, True), (72, 96, True), (80, 96, False),
                                            (96, 96, False), (97, 128, True), (136, 160, True),
                                            (144, 160, False), (160, 160, False),
                                            (176, 192, False), (193, 224, True),
                                            (200, 224, False), (216, 224, False),
                                            (224, 224, False), (225, 256, True),
                                            (232, 256, False), (248, 256, False),
                                            (252, 256, True), (256, 256, False)])
def test_widths_between_the_builds(d, width, staged):
    """The rows the issue's table names and their neighbours: 65-96 at 96,
    129-160 at 160, 193-224 at 224; rows off 32 bytes (d % 16 == 8) staged
    below 193 and read in place above."""
    assert fa.headmajor_width(BF16, d) == width
    assert fa.headmajor_staged(BF16, d) == staged
    assert fa.attention_body("attention_headmajor", BF16, d) == ("sm90" if d <= 192 else "sm90_ws")


def _source(name):
    return (CSRC / name).read_text()


def test_c_sources_and_python_mirrors_agree():
    """The C routes (``kBf16Widths``, the rows each body reads in place,
    ``sm90_route``'s bf16 bounds, ``tf32_width``) are the ones the Python
    mirrors hold, read out of the sources."""
    sm90 = _source("attention_sm90.cuh")
    widths = re.search(r"constexpr int kBf16Widths\[\] = \{([^}]*)\};", sm90)
    assert tuple(int(x) for x in widths[1].split(",")) == fa.BF16_HEAD_DIMS
    assert int(re.search(r"constexpr int kStageUnit = (\d+);", sm90)[1]) == fa.STAGE_ROW_UNIT
    ws = _source("attention_sm90_ws.cuh")
    assert int(re.search(r"constexpr int kRowUnit = (\d+);", ws)[1]) == fa.WS_ROW_UNIT
    assert re.search(r"HD == 128 \|\| HD == 224 \|\| HD == 256", ws)
    assert re.search(r"HD == 64 \|\| HD == 96 \|\| HD == 128 \|\| HD == 160 \|\| HD == 192", sm90)
    route = re.search(r"if \(dtype == 1 && head_dim > 0\) return head_dim <= (\d+) \? 1 : "
                      r"head_dim <= kMaxHeadDim \? 6 : 2;", sm90)
    assert int(route[1]) == 192 == max(w for w in fa.BF16_HEAD_DIMS
                                       if fa.attention_body("attention_headmajor", BF16, w)
                                       == "sm90")
    tf32 = re.search(r"inline int tf32_width\(int d\) \{\s*return ([^;]*);", sm90)[1]
    assert re.findall(r"d <= (\d+) \? (\d+)", tf32) == [(str(w), str(w))
                                                       for w in fa.HEADMAJOR_HEAD_DIMS]
    head = _source("attention_headmajor.cu")
    assert [int(w) for w in re.findall(r"case (\d+):\s*return run<\1>", head)] == \
        list(fa.BF16_HEAD_DIMS)
    assert "constexpr bool ws = HD > 192;" in head


def _tables(N, d, seed):
    """(N, d) tables of random angles, one a column: rotate-half at any d."""
    ang = np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)
    return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, 250), (1205, 1190)])
@pytest.mark.parametrize("d", [96, 160, 200, 224, 232, 248])
def test_plain_headmajor_matches_jax_at_half_atom_widths(d, N, n_valid, rope):
    """The plain K3 against the JAX kernel in interpret mode, bf16, one
    image of two heads, NaN in the K/V rows from n_valid. Tolerance: the JAX
    kernel ropes and scales in bf16 arithmetic where the port rounds once
    from fp32, so each roped element may differ by a few bf16 ulps: the
    output by 2^-6 of its size plus 2^-5 of the largest live |v|
    (``test_torch_attention_layouts.py``'s bf16 bound)."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    rng = np.random.default_rng(90 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, N, d)).astype(np.float32))
               for _ in range(3))
    k[:, :, n_valid:] = float("nan")
    v[:, :, n_valid:] = float("nan")
    cos, sin = _tables(N, d, seed=91) if rope else (None, None)
    want = np.asarray(jfa.fused_attention(
        *(jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (q, k, v)), d ** -0.5,
        n_valid=n_valid, rope_cos=None if cos is None else jnp.asarray(cos.numpy()),
        rope_sin=None if sin is None else jnp.asarray(sin.numpy()), interpret=True,
    ).astype(jnp.float32))
    got = fa.fused_attention(*(t.to(BF16) for t in (q, k, v)), d ** -0.5, n_valid, cos, sin)
    got = got.float().numpy()
    assert got.shape == (1, 2, N, d) and np.isfinite(got).all()
    vmax = float(v[:, :, :n_valid].to(BF16).float().abs().max())
    tol = np.abs(want) * 2.0 ** -6 + 2.0 ** -5 * vmax
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("d", [200, 232, 248])
def test_in_place_rows_off_32_bytes_take_the_unstaged_build(d):
    """``chip_smoke.kernel_ptxas`` names the build a call runs: the
    two-consumer body's rows off 32 bytes read in place run the same
    instantiation as rows of whole 32-byte units (at 256 O by TMA stores on
    its map at d), with no staging launch; a d % 8 != 0 beside them its
    ``staged`` form."""
    import chip_smoke

    width = fa.headmajor_width(BF16, d)
    reports = {f"sm90_ws<{width}, 4>": "A", f"sm90_ws<{width}, 4, staged>": "B"}
    saved = dict(chip_smoke.PTXAS)
    chip_smoke.PTXAS.clear()
    chip_smoke.PTXAS["attention_headmajor"] = reports
    try:
        assert not fa.headmajor_staged(BF16, d) and fa.headmajor_staged(BF16, d - 4)
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, d) == "A"
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, width) == "A"
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, d - 4) == "B"
    finally:
        chip_smoke.PTXAS.clear()
        chip_smoke.PTXAS.update(saved)


def test_chip_smoke_reports_every_new_build():
    """``chip_smoke.bf16_builds`` reads ptxas's report of the one-warpgroup
    body at 96 and 160 and the two-consumer body at 224 and 256 in K3's
    library: registers, spills, serialized wgmma and (the two-consumer
    body) C7508, raising on any of those or on a missing build."""
    import chip_smoke

    reports = {f"sm90<{w}, {r}{s}>": "150 regs, 0/0 spill" for w in (96, 160) for r in (4, 5)
               for s in ("", ", staged") if not (s and r == 5)}
    reports |= {f"sm90_ws<{w}, {r}{s}>": "168 regs, 0/0 spill" for w in (224, 256)
                for r in (4, 5) for s in ("", ", staged") if not (s and r == 5)}
    reports["sm90<128, 4>"] = "128 regs, 0/0 spill"
    saved = dict(chip_smoke.PTXAS)
    chip_smoke.PTXAS.clear()
    chip_smoke.PTXAS["attention_headmajor"] = reports
    try:
        got = chip_smoke.bf16_builds()
        assert set(got) == {f"attention_headmajor: {k}" for k in reports if k != "sm90<128, 4>"}
        assert got["attention_headmajor: sm90_ws<224, 4>"] == {
            "registers": 168, "spill_stores": 0, "spill_loads": 0, "wgmma_serialized": False,
            "setmaxnreg_ignored": False}
        for bad in ("150 regs, 8/8 spill", "150 regs, 0/0 spill, wgmma serialized",
                    "150 regs, 0/0 spill, setmaxnreg ignored"):
            reports["sm90<96, 4>"] = bad
            with pytest.raises(AssertionError, match="ptxas"):
                chip_smoke.bf16_builds()
        reports["sm90<96, 4>"] = "150 regs, 0/0 spill"
        del reports["sm90_ws<224, 5>"]
        with pytest.raises(AssertionError, match="sm90_ws<224, 5>"):
            chip_smoke.bf16_builds()
    finally:
        chip_smoke.PTXAS.clear()
        chip_smoke.PTXAS.update(saved)
