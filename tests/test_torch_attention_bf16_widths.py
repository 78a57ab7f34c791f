"""K3 in bfloat16 at every head dim: the routing, the staging pass's plain
version and the plain K3 against the JAX package's, on the CPU.

Every bf16 head of width d up to 256 runs the Hopper body
(``csrc/attention_sm90.cuh``) at the next of 64, 128, 192 and 256 with its
tensor maps at d, in place: no pad copy and no RoPE in torch. A row of d
elements that is no 32-byte multiple (d % 16 != 0) goes through one staging
launch first (``stage_rows``, ``csrc/attention_common.cuh``), which copies q
(roped, times the scale), k (roped) and v into scratch rows of d rounded up
to 16; above 256 the wide body ropes an odd d with the same pass. The
staging pass's plain version (``fa.bf16_stage_reference``) is held here
against the JAX package's rotate-half (``cbas_tpu/models/vit.py::_rot_half``,
the pairing of ``cbas_tpu/ops/flash_attention.py``'s kernel), bit for bit,
and the plain K3 against the JAX kernel (Pallas interpret mode) with NaN in
the dead K/V rows. Inputs come from numpy seeds.

The ``cuda`` tests hold the kernels against their plain versions and skip
without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_bf16_widths.py
"""

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import flash_attention as fa
# The sibling module by its own name (pytest puts tests/ on the path): its
# bf16 bound on the card, one rounding of the output and of p apart.
from test_torch_attention_layouts import _card_tolerance

BF16 = torch.bfloat16
KERNELS = ("attention_fat", "attention_packed", "attention_headmajor")
# (B, H, N, d, n_valid, RoPE): phase 10's bf16 widths (32, 96, 100, 150) and
# an odd one with RoPE (65) at a small size, n_valid < N with NaN in the dead
# rows.
JAX_CASES = [(1, 2, 80, d, 70, rope) for d in (32, 96, 100, 150) for rope in (False, True)] + [
    (1, 2, 80, 65, 70, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _inputs(shape, seed, dtype=BF16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _tables(N, d, seed):
    """(N, d) tables of random angles, one a column: rotate-half at any d."""
    ang = np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)
    return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


def _built(d):
    return next(w for w in fa.HEADMAJOR_HEAD_DIMS if w >= d)


@pytest.mark.parametrize("rope", [False, True])
def test_every_bf16_width_runs_in_place_on_the_hopper_or_wide_body(rope):
    """d 1-300: up to 256 the Hopper body at the next of 64, 128, 192 and
    256, above 256 the wide body at d; every width in place (no pad copy,
    no RoPE in torch), with tables and without."""
    for d in range(1, 301):
        width = fa.headmajor_width(BF16, d)
        assert width == (_built(d) if d <= 256 else d), d
        body = "sm90" if d <= 256 else "wide"
        assert fa.attention_body("attention_headmajor", BF16, width) == body, d
        assert fa.attention_body("attention_headmajor", BF16, d) == body, d
        assert fa.headmajor_in_place(BF16, d, rope), d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_entry_names_a_body_outside_the_five(dtype):
    """``attention_body`` returns one of the five bodies the C entries
    report, or raises for what no entry takes (K1 and K2 off d 64); the
    common body is gone."""
    bodies = set(fa._BODIES.values())
    assert bodies == {"sm90", "wide", "sm90_f32", "sm90_f32_wide", "sm90_f32_slices"}
    for kernel in KERNELS:
        for d in range(1, 301):
            if kernel != "attention_headmajor" and d != fa.HEAD_DIM:
                with pytest.raises(ValueError, match="takes no head dim"):
                    fa.attention_body(kernel, dtype, d)
                continue
            assert fa.attention_body(kernel, dtype, d) in bodies, (kernel, d)
    with pytest.raises(ValueError, match="no attention body"):
        fa.attention_body("attention_headmajor", torch.float16, 64)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [65, 100, 150])
def test_stage_plain_version_against_jax_rotate_half(d, rope):
    """The staging pass's plain version: q roped by the JAX package's
    rotate-half (its permutation and signs, exact in fp32) times the scale,
    k roped, each rounded to bf16 once; v bit for bit; rows of k and v at or
    beyond n_valid and the columns from d to the next multiple of 16 zeros.
    Without tables q is q times the scale and k passes bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.models.vit import _rot_half

    B, H, N, nv = 2, 3, 40, 33
    q, k, v = _inputs((B, H, N, d), seed=60)
    cos, sin = _tables(N, d, seed=61) if rope else (None, None)
    scale = d ** -0.5
    got = fa.bf16_stage_reference(q, k, v, scale, nv, cos, sin)
    w = -(-d // 16) * 16
    assert fa.stage_width(d) == w
    assert got.shape == (3, B, H, N, w) and got.dtype == BF16

    def roped(t):
        x = t.float()
        if not rope:
            return x
        rot = torch.from_numpy(np.array(_rot_half(jnp.asarray(x.numpy()))))
        return x * cos + rot * sin

    assert torch.equal(got[0, ..., :d], (roped(q) * scale).to(BF16))
    assert torch.equal(got[1, :, :, :nv, :d], roped(k)[:, :, :nv].to(BF16))
    assert torch.equal(got[2, :, :, :nv, :d], v[:, :, :nv])
    assert not got[..., d:].any() and not got[1:, :, :, nv:].any()
    if not rope:
        assert torch.equal(got[1, :, :, :nv, :d], k[:, :, :nv])
    # Its pairing is rotate_half's, which the plain K3 uses.
    x = torch.arange(d, dtype=torch.float32)
    assert torch.equal(fa.rotate_half(x),
                       torch.from_numpy(np.array(_rot_half(jnp.asarray(x.numpy())))))


@pytest.mark.parametrize("B,H,N,d,n_valid,rope", JAX_CASES)
def test_plain_headmajor_matches_jax_at_bf16_widths(B, H, N, d, n_valid, rope):
    """The plain K3 (the wrapper on CPU tensors) against the JAX kernel in
    interpret mode, bf16, NaN in the dead K/V rows. Tolerance: the JAX
    kernel ropes and scales in bf16 arithmetic where the port rounds once
    from fp32, so each roped element may differ by a few bf16 ulps: the
    output by 2^-6 of its size plus 2^-5 of the largest live |v|
    (``test_torch_attention_layouts.py``'s bf16 bound)."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    q, k, v = _inputs((B, H, N, d), seed=62, dtype=torch.float32)
    k[:, :, n_valid:] = float("nan")
    v[:, :, n_valid:] = float("nan")
    cos, sin = _tables(N, d, seed=63) if rope else (None, None)
    want = np.asarray(jfa.fused_attention(
        *(jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (q, k, v)), d ** -0.5,
        n_valid=n_valid, rope_cos=None if cos is None else jnp.asarray(cos.numpy()),
        rope_sin=None if sin is None else jnp.asarray(sin.numpy()), interpret=True,
    ).astype(jnp.float32))
    got = fa.fused_attention(*(t.to(BF16) for t in (q, k, v)), d ** -0.5, n_valid, cos, sin)
    got = got.float().numpy()
    assert got.shape == (B, H, N, d) and np.isfinite(got).all()
    vmax = float(v[:, :, :n_valid].to(BF16).float().abs().max())
    tol = np.abs(want) * 2.0 ** -6 + 2.0 ** -5 * vmax
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("d", [65, 100, 150, 301])
def test_staged_route_equals_plain_version(d):
    """What the card runs for a bf16 row that is no 32-byte multiple: the
    staging pass (rows of d rounded up to 16 below 256; of d above, the wide
    body's RoPE scratch), then attention on its first d columns without
    tables at scale 1. Through the plain versions, bit for bit the plain K3
    with tables."""
    N, nv = 50, 44
    q, k, v = _inputs((2, 3, N, d), seed=64)
    cos, sin = _tables(N, d, seed=65)
    scale = d ** -0.5
    staged = fa.bf16_stage_reference(q, k, v, scale, nv, cos, sin, width=d if d > 256 else None)
    got = fa.attention_headmajor_reference(*staged[..., :d], 1.0, nv)
    assert torch.equal(got, fa.attention_headmajor_reference(q, k, v, scale, nv, cos, sin))


def test_stage_wrapper_on_the_cpu_and_its_refusals():
    """``fa.bf16_stage`` on CPU tensors is its plain version; it takes views
    at any 2-byte alignment and refuses fp32 and strides it cannot read."""
    B, H, N, d = 1, 3, 20, 65
    qkv = _inputs((B, N, 3 * H * d), seed=66)[0]
    q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2)
               for j in range(3))
    assert k.data_ptr() % 16  # 390 bytes in: no 16-byte alignment
    cos, sin = _tables(N, d, seed=67)
    got = fa.bf16_stage(q, k, v, 0.125, 17, cos, sin)
    assert torch.equal(got, fa.bf16_stage_reference(q, k, v, 0.125, 17, cos, sin))
    with pytest.raises(ValueError, match="bf16"):
        fa.bf16_stage(*(t.float() for t in (q, k, v)), 0.125)
    with pytest.raises(ValueError, match="must share strides"):
        fa.bf16_stage(q, k.contiguous(), v, 0.125)


def test_stage_launches_count_apart(monkeypatch):
    """A K3 launch that staged counts one staging launch, never an fp32
    prologue launch; the fp32 bodies' prologue the other way round."""
    for name in ("launches_stage", "launches_tf32_prologue", "launches_sm90"):
        monkeypatch.setattr(fa, name, 0)
    monkeypatch.setattr(fa, "launches_headmajor_by_dim", {})
    fa._count_launch("attention_headmajor", 128, "sm90", 1)
    fa._count_launch("attention_headmajor", 301, "wide", 1)
    fa._count_launch("attention_headmajor", 128, "sm90_f32", 1)
    assert (fa.launches_stage, fa.launches_tf32_prologue, fa.launches_sm90) == (2, 1, 1)
    assert fa.launches_headmajor_by_dim == {128: 2, 301: 1}


# --- on the card --------------------------------------------------------------

def _cuda_kernels(fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` ran, from a
    ``torch.profiler`` trace (``chip_smoke.trace_kernels``: on the card's
    machine a trace may lose its events, so an empty one is taken again)."""
    import chip_smoke

    return chip_smoke.trace_kernels(torch, fn)


CARD_CASES = [(8, 16, 261, 32, None), (8, 16, 261, 96, None), (4, 16, 1205, 96, None),
              (4, 16, 1205, 150, None), (8, 16, 261, 100, None), (2, 3, 272, 100, 261),
              (2, 3, 272, 65, 261), (1, 3, 140, 13, 130), (1, 5, 140, 301, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused views"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("B,H,N,d,n_valid", CARD_CASES)
def test_bf16_widths_match_plain_on_card(B, H, N, d, n_valid, rope, layout, cuda_device):
    """K3 in bf16 at the widths the common body or the pad copies took
    before, against the plain version, NaN in the dead K/V rows, on
    contiguous tensors and on head-major views of one fused (B, N, 3*H*d)
    projection (at H 3 and 5 and an odd d, bases at 2-byte alignment only):
    one K3 launch through the Hopper body (the wide body above 256), a
    staging launch where a row is no 32-byte multiple (above 256: at an odd
    d with tables), no copy kernel, the output dense in q's dim order."""
    rng = np.random.default_rng(68)
    if layout == "fused views":
        qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(
            cuda_device, BF16)
        q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2)
                   for j in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).to(
            cuda_device, BF16) for _ in range(3))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = (t.to(cuda_device) for t in _tables(N, d, seed=69))
    width = fa.headmajor_width(BF16, d)
    body = "sm90" if d <= 256 else "wide"
    staged = fa.headmajor_staged(BF16, d, rope)
    assert staged == (d % 16 != 0 if d <= 256 else (rope and d % 2 == 1))

    def counts():
        return (fa.launches_headmajor_by_dim.get(width, 0), fa.launches_sm90, fa.launches_wide,
                fa.launches_stage)

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + 1, before[1] + (body == "sm90"),
                        before[2] + (body == "wide"), before[3] + staged)
    assert got.shape == (B, H, N, d) and got.stride() == fa._dense_like(q).stride()
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())
    copies = fa.fused_attention(*(t.contiguous() for t in (q, k, v)), d ** -0.5, n_valid, cos, sin)
    assert torch.equal(got, copies)
    kernels = _cuda_kernels(lambda: fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin))
    assert not any("copy" in name.lower() or "elementwise" in name.lower() for name in kernels), \
        kernels
    assert sum("stage_rows" in name for name in kernels) == staged, kernels
    if d <= 256:
        assert len(kernels) == (2 if staged else 1 + rope), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("B,H,N,d,n_valid", CARD_CASES)
def test_stage_kernel_bit_for_bit_on_card(B, H, N, d, n_valid, rope, cuda_device):
    """The staging pass alone (``fa.bf16_stage``) on head-major views of one
    fused projection, bit for bit its plain version, NaN in the dead K/V
    rows (not read: those rows stay zero)."""
    rng = np.random.default_rng(70)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(cuda_device, BF16)
    q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2)
               for j in range(3))
    nv = n_valid or N
    k[:, :, nv:] = float("nan")
    v[:, :, nv:] = float("nan")
    cos, sin = (t.to(cuda_device) for t in _tables(N, d, seed=71)) if rope else (None, None)
    before = fa.launches_stage
    got = fa.bf16_stage(q, k, v, d ** -0.5, nv, cos, sin)
    assert fa.launches_stage == before + 1
    assert torch.equal(got, fa.bf16_stage_reference(q, k, v, d ** -0.5, nv, cos, sin))


def test_chip_smoke_names_the_staged_kernels():
    """``chip_smoke.py``'s labels and ptxas lookup know the Hopper body's
    staged form and the staging pass, and compare the unstaged form's
    mangled name with a checkout that has no such template argument."""
    import chip_smoke

    stem = "_ZN13cbas_attention4sm9014attention_sm90ILi128ELi4ELi0E{}EEvv"
    assert chip_smoke.kernel_label(stem.format("Lb1E")) == "sm90<128, 4, staged>"
    assert chip_smoke.kernel_label(stem.format("Lb0E")) == "sm90<128, 4>"
    old = "_ZN13cbas_attention4sm9014attention_sm90ILi128ELi4ELi0EEEvv"
    assert chip_smoke.comparable_name(stem.format("Lb0E")) == chip_smoke.comparable_name(old)
    assert chip_smoke.comparable_name(stem.format("Lb1E")) != chip_smoke.comparable_name(old)
    args = "v14CUtensorMap_stS2_S2_S2_PKfS4_iifNS0_10MapAddressE"  # a parent's, then this tree's
    assert chip_smoke.comparable_name(
        "_ZN14cbas_attention4sm9014attention_sm90ILi64ELi4ELi0ELb0EEE" + args + "NS0_8PlainOutE") \
        == chip_smoke.comparable_name("_ZN14cbas_attention4sm9014attention_sm90ILi64ELi4ELi0EEE" + args)
    assert chip_smoke.kernel_label(
        "_ZN13cbas_attention10stage_rowsI13__nv_bfloat16Li8ELi4EEEvv") == "stage_rows<bf16, 8, 4>"
    log = {"sm90<128, 4>": "168 regs, 0/0 spill", "sm90<128, 4, staged>": "170 regs, 0/0 spill"}
    saved = dict(chip_smoke.PTXAS)
    chip_smoke.PTXAS["attention_headmajor"] = log
    try:
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, 96) == log["sm90<128, 4>"]
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, 100) == \
            log["sm90<128, 4, staged>"]
    finally:
        chip_smoke.PTXAS.clear()
        chip_smoke.PTXAS.update(saved)


def test_chip_smoke_finds_copies_past_the_staging_pass():
    """``copies_around`` steps over the RoPE prologue and the staging pass
    before K3, so a copy before either still counts as next to K3."""
    import chip_smoke

    clean = ["gemm", "stage_rows<bf16>", "attention_sm90<128>", "gemm"]
    assert chip_smoke.copies_around(clean, "attention_sm90")["copies_around"] == 0
    copied = ["gemm", "elementwise_copy", "stage_rows<bf16>", "rope_rows<bf16>",
              "attention_sm90<128>", "Memcpy DtoD"]
    got = chip_smoke.copies_around(copied, "attention_sm90")
    assert (got["launches"], got["copies_around"]) == (1, 2)


def test_chip_smoke_staging_bytes():
    """The staging pass's byte bound: q, k and v read at d and written at d
    rounded up to 16 (bf16), and with RoPE the fp32 tables read once."""
    import chip_smoke

    assert (fa.stage_width(100), fa.stage_width(65), fa.stage_width(96)) == (112, 80, 96)
    assert chip_smoke.staging_bytes(4, 1205, 16, 100, 112, False) == 2 * 3 * 4 * 16 * 1205 * 212
    assert chip_smoke.staging_bytes(1, 10, 1, 65, 80, True) == 2 * 3 * 10 * 145 + 2 * 10 * 65 * 4
