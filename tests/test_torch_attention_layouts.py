"""cbas_tpu_torch's packed (K2) and head-major (K3) fused attention against
the JAX package's.

The JAX kernels run as their own tests run them on the CPU (Pallas interpret
mode); the port's wrappers, given CPU tensors, run their plain versions.
Inputs come from one numpy seed, at the JAX suite's own shapes
(``tests/test_flash_attention.py``). Tolerance: atol/rtol 2e-5 in fp32, 3e-5
with RoPE, the JAX suite's bounds (both sides compute in fp32; only
summation order differs, and RoPE adds two roundings).

The ``cuda`` tests hold each CUDA kernel against its plain version and skip
without a card. This file imports jax only inside the JAX-parity tests, so on
a card's machine without jax the ``cuda`` tests run on their own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_layouts.py
"""

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import flash_attention as fa

TOL, TOL_ROPE = 2e-5, 3e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rope(N, d, seed):
    """(N, d) tables with tiled halves, as the JAX suite builds them."""
    ang = np.random.default_rng(seed).standard_normal((N, d // 2)).astype(np.float32)
    return (np.concatenate([np.cos(ang)] * 2, axis=-1),
            np.concatenate([np.sin(ang)] * 2, axis=-1))


def _both(jax_entry, port_entry, q, k, v, n_valid=None, rope=None, **jax_kw):
    """One case through the JAX kernel (interpret mode) and the port's
    wrapper on CPU tensors; returns (port, jax) as numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    d = q.shape[-1] if port_entry is fa.fused_attention else fa.HEAD_DIM
    scale = d ** -0.5
    cos, sin = rope if rope is not None else (None, None)
    want = getattr(jfa, jax_entry)(
        *(jnp.asarray(t) for t in (q, k, v)), scale, n_valid=n_valid,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin),
        interpret=True, **jax_kw,
    )
    got = port_entry(
        *(torch.from_numpy(t) for t in (q, k, v)), scale, n_valid=n_valid,
        rope_cos=None if cos is None else torch.from_numpy(cos),
        rope_sin=None if sin is None else torch.from_numpy(sin),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize(
    "B,H,N,d,n_valid",
    [
        (2, 2, 128, 64, None),   # aligned
        (1, 3, 261, 64, None),   # ViT-ish N, an odd head count
        (2, 1, 37, 32, None),    # tiny N below one tile
        (1, 2, 140, 128, None),  # DINOv3 ViT-7B's head width
        (1, 2, 272, 64, 261),    # the 256x256 token count padded, pad keys masked
        (1, 2, 272, 128, 261),
        (2, 2, 48, 32, 40),
        (1, 2, 80, 192, None),   # wider than any shipped preset's heads
        (1, 1, 96, 192, 90),
    ],
)
def test_headmajor_reference_matches_jax(B, H, N, d, n_valid, rope):
    q, k, v = _inputs((B, H, N, d), seed=20)
    got, want = _both(
        "fused_attention", fa.fused_attention, q, k, v, n_valid,
        _rope(N, d, seed=21) if rope else None,
    )
    assert got.shape == (B, H, N, d)
    tol = TOL_ROPE if rope else TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [12, 36, 100, 136, 160, 200])
def test_headmajor_at_widths_the_kernel_pads_matches_jax(d, rope):
    """Head dims K3 is not built at (the card runs them at the next of 64,
    128, 192 and 256, its maps at d; in bf16 12, 36 and 100 through the
    staging launch, in fp32 they are multiples of 4) against the JAX kernel,
    which takes any d, with NaN in the dead K/V rows."""
    B, H, N, n_valid = 1, 2, 80, 70
    q, k, v = _inputs((B, H, N, d), seed=40)
    k[:, :, n_valid:] = np.nan
    v[:, :, n_valid:] = np.nan
    got, want = _both("fused_attention", fa.fused_attention, q, k, v, n_valid,
                      _rope(N, d, seed=41) if rope else None)
    assert np.isfinite(got).all()
    tol = TOL_ROPE if rope else TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [6, 14, 38, 98, 130, 162, 254])
def test_plain_version_on_padded_heads_equals_it_at_d(d, rope):
    """What the card runs for an fp32 width that is no multiple of 4 (the
    one head K3 still copies): q, k, v (and the tables, half by half)
    zero-padded to the next multiple of 4, attention there, the output
    sliced back. The plain version through that detour equals the plain
    version at d."""
    width = fa.padded_head_dim(d)
    assert width % 4 == 0 and d < width < d + 4
    assert fa.padded_head_dim(width) == width
    assert not fa.headmajor_in_place(torch.float32, d) and fa.headmajor_in_place(torch.float32,
                                                                                  width)
    N, n_valid = 90, 83
    q, k, v = (torch.from_numpy(t) for t in _inputs((2, 3, N, d), seed=42))
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t) for t in _rope(N, d, seed=43))
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    pad = [fa.pad_head_dim(t, width, rope) for t in (q, k, v)]
    if rope:
        cos, sin = (fa.pad_head_dim(t, width, True) for t in (cos, sin))
    padded = fa.attention_headmajor_reference(*pad, d ** -0.5, n_valid, cos, sin)
    assert padded.shape[-1] == width
    np.testing.assert_allclose(fa.unpad_head_dim(padded, d, rope).numpy(), want.numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(fa.unpad_head_dim(pad[2], d, rope), v)  # the round trip is exact


def _bf16_tolerance(want, v, n_valid, N):
    """bf16 against the JAX kernel (interpret mode), which ropes and scales
    in bf16 arithmetic where the port rounds once from fp32: each roped
    element may differ by a few bf16 ulps, so each score by about 2^-6 of
    its size, each p by as much, and the output by 2^-5 of the largest |v|
    plus 2^-6 of its own size."""
    vmax = np.abs(v[..., : n_valid or N, :].astype(np.float32)).max()
    return np.abs(want) * 2.0 ** -6 + 2.0 ** -5 * vmax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "d,rope,n_valid",
    [
        (320, False, None),  # wider than 256: the card's wide body
        (320, True, 70),
        (384, True, None),
        (384, False, 70),
        (65, True, None),    # odd with tables: roped before the launch on the card
        (65, True, 70),
        (97, True, 70),
    ],
)
def test_wide_and_odd_rope_heads_match_jax(d, rope, n_valid, dtype):
    """The two head dims K3 refused on the card before (above 256; odd with
    RoPE) against the JAX kernel, which takes any d, NaN in the dead K/V rows.
    fp32: the JAX suite's bound. bf16: :func:`_bf16_tolerance`."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    B, H, N = 1, 2, 80
    q, k, v = _inputs((B, H, N, d), seed=46)
    if n_valid is not None:
        k[:, :, n_valid:] = np.nan
        v[:, :, n_valid:] = np.nan
    cos = sin = None
    if rope:
        cos, sin = _rope(N, d - d % 2, seed=47)
        if d % 2:  # rotate-half tables of an odd head: one more angle column
            ang = np.random.default_rng(48).standard_normal((N, d)).astype(np.float32)
            cos, sin = np.cos(ang), np.sin(ang)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfa.fused_attention(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), d ** -0.5, n_valid=n_valid,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin), interpret=True,
    ).astype(jnp.float32))
    got = fa.fused_attention(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)), d ** -0.5, n_valid,
        None if cos is None else torch.from_numpy(cos),
        None if sin is None else torch.from_numpy(sin),
    ).float().numpy()
    assert got.shape == (B, H, N, d) and np.isfinite(got).all()
    if dtype == "float32":
        tol = TOL_ROPE if rope else TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        vb = torch.from_numpy(v).to(tdt).float().numpy()
        assert (np.abs(got - want) <= _bf16_tolerance(want, vb, n_valid, N)).all(), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [13, 65, 97, 261])
def test_odd_rope_detour_equals_plain_version(d, dtype):
    """What the card runs for an odd head with tables: q and k roped
    beforehand (the scale folded into q, one rounding to the dtype), then
    attention without tables at scale 1 (fp32: by the wrapper in torch;
    bf16: by the staging launch, whose plain version writes rows rounded up
    to 8 below 256 and of d above, the wide body's scratch). The plain
    version through that detour equals the plain version with tables bit for
    bit: both round at the same points."""
    N, n_valid = 70, 61
    q, k, v = (torch.from_numpy(t).to(dtype) for t in _inputs((2, 3, N, d), seed=49))
    ang = torch.from_numpy(np.random.default_rng(50).standard_normal((N, d)).astype(np.float32))
    cos, sin = torch.cos(ang), torch.sin(ang)
    scale = d ** -0.5
    want = fa.attention_headmajor_reference(q, k, v, scale, n_valid, cos, sin)
    if dtype == torch.bfloat16:
        staged = fa.bf16_stage_reference(q, k, v, scale, n_valid, cos, sin,
                                         width=d if d > 256 else None)[..., :d]
        got = fa.attention_headmajor_reference(*staged, 1.0, n_valid)
    else:
        got = fa.attention_headmajor_reference(
            fa._rope_heads(q, cos, sin, scale), fa._rope_heads(k, cos, sin), v, 1.0, n_valid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [257, 320, 384, 1000])
def test_heads_above_256_run_at_their_own_width(d):
    """Above 256 the card runs the wide body (bf16) or the slices body
    (fp32) at d itself: no padding."""
    assert fa.padded_head_dim(d) == d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,N,d,n_valid,rope",
    [
        (8, 16, 261, 320, None, True),   # the wide body, at phase 10's shapes
        (4, 8, 1205, 384, None, True),
        (2, 4, 272, 320, 261, False),    # pad keys masked, NaN in the dead rows
        (2, 4, 140, 384, 130, True),
        (1, 2, 100, 257, 90, False),     # an odd d above 256, no tables
        (8, 16, 261, 65, None, True),    # odd with tables: the staging launch ropes (bf16)
        (2, 4, 272, 97, 261, True),
        (1, 2, 140, 301, 130, True),     # odd above 256 with tables
    ],
)
def test_wide_and_odd_rope_kernel_matches_plain_on_card(B, H, N, d, n_valid, rope, dtype,
                                                        cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt) for t in _inputs((B, H, N, d), seed=51))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos = sin = None
    if rope:
        ang = np.random.default_rng(52).standard_normal((N, d)).astype(np.float32)
        cos, sin = (torch.from_numpy(f(ang)).to(cuda_device) for f in (np.cos, np.sin))
    width = fa.headmajor_width(dt, d)
    before = fa.launches_headmajor_by_dim.get(width, 0)
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert fa.launches_headmajor_by_dim[width] == before + 1
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert got.shape == (B, H, N, d) and bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


@pytest.mark.parametrize("pvt", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize(
    "B,G,N,n_valid",
    [
        (2, 2, 128, None),  # aligned, two pairs
        (1, 1, 261, None),  # N not a tile multiple
        (2, 1, 200, 190),   # model-level padding masked as keys
    ],
)
def test_packed_reference_matches_jax(B, G, N, n_valid, rope, pvt):
    """Against both of the JAX kernel's score orientations: the port has one."""
    q, k, v = _inputs((B, G, N, 2 * fa.HEAD_DIM), seed=22)
    got, want = _both(
        "fused_attention_packed", fa.fused_attention_packed, q, k, v, n_valid,
        _rope(N, fa.HEAD_DIM, seed=23) if rope else None, pvt=pvt,
    )
    assert got.shape == (B, G, N, 2 * fa.HEAD_DIM)
    tol = TOL_ROPE if rope else TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "entry,jax_entry,shape",
    [
        (fa.fused_attention, "fused_attention", (2, 2, 80, 128)),
        (fa.fused_attention, "fused_attention", (2, 3, 80, 40)),
        (fa.fused_attention_packed, "fused_attention_packed", (2, 2, 80, 128)),
    ],
)
def test_dead_rows_cannot_leak(entry, jax_entry, shape):
    """NaN in K/V rows at or beyond n_valid leaves every output finite, equal
    to attention over the live rows alone and to the JAX kernel's output."""
    q, k, v = _inputs(shape, seed=24)
    k[:, :, 70:] = np.nan
    v[:, :, 70:] = np.nan
    d = shape[-1] if entry is fa.fused_attention else fa.HEAD_DIM
    rope = _rope(shape[2], d, seed=25)
    got, want = _both(jax_entry, entry, q, k, v, 70, rope)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL_ROPE, atol=TOL_ROPE)
    # The first 70 query rows against attention over the first 70 tokens.
    t = [torch.from_numpy(np.ascontiguousarray(x[:, :, :70])) for x in (q, k, v)]
    cos, sin = (torch.from_numpy(np.ascontiguousarray(x[:70])) for x in rope)
    only_live = entry(*t, d ** -0.5, None, cos, sin)
    np.testing.assert_allclose(got[:, :, :70], only_live.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_plain_versions_compute_one_function(dtype):
    """The packed and head-major plain versions over the same heads equal the
    flat one exactly, in fp32 and in bf16 (same rounding points)."""
    B, H, N = 2, 4, 70
    gen = torch.Generator().manual_seed(0)
    flat = [torch.randn(B, N, H * 64, generator=gen).to(dtype) for _ in range(3)]
    cos, sin = (torch.from_numpy(t) for t in _rope(N, 64, seed=26))
    want = fa.attention_fat_reference(*flat, 0.125, 60, cos, sin)

    def headmajor(t):
        return t.reshape(B, N, H, 64).transpose(1, 2).contiguous()

    def packed(t):
        return t.reshape(B, N, H // 2, 128).transpose(1, 2).contiguous()

    hm = fa.fused_attention(*(headmajor(t) for t in flat), 0.125, 60, cos, sin)
    pk = fa.fused_attention_packed(*(packed(t) for t in flat), 0.125, 60, cos, sin)
    assert torch.equal(hm.transpose(1, 2).reshape(B, N, H * 64), want)
    assert torch.equal(pk.transpose(1, 2).reshape(B, N, H * 64), want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    # Off the CPU (a meta tensor reaches the same checks as a CUDA one, before
    # any launch): a head wider than 256, and RoPE on an odd head dim, pass
    # every check and stop only at the launch, which takes cpu or cuda.
    for d, table in ((264, None), (13, torch.ones(16, 13, device="meta"))):
        q = torch.zeros(1, 2, 16, d, device="meta")
        with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
            fa.fused_attention(q, q, q, 0.1, rope_cos=table, rope_sin=table)
    q = torch.zeros(1, 2, 16, 96)
    with pytest.raises(ValueError, match=r"rope_cos must be \(16, 96\)"):
        fa.fused_attention(q, q, q, 0.1, rope_cos=torch.ones(16, 64), rope_sin=torch.ones(16, 64))
    with pytest.raises(ValueError, match="head-major"):
        fa.fused_attention(q[0], q[0], q[0], 0.1)
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="packed"):
        fa.fused_attention_packed(q, q, q, 0.1)
    q = torch.zeros(1, 2, 16, 128)
    with pytest.raises(ValueError, match="n_valid"):
        fa.fused_attention_packed(q, q, q, 0.1, n_valid=17)
    with pytest.raises(ValueError, match="does not match"):
        fa.fused_attention_packed(q, q[:, :1], q, 0.1)


def test_cpu_tensors_never_count_as_launches():
    before = (fa.launches, fa.launches_packed, fa.launches_headmajor,
              dict(fa.launches_headmajor_by_dim))
    q = torch.zeros(1, 2, 16, 128)
    fa.fused_attention(q, q, q, 0.1)
    fa.fused_attention_packed(q, q, q, 0.1)
    assert (fa.launches, fa.launches_packed, fa.launches_headmajor,
            fa.launches_headmajor_by_dim) == before


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "off", "OFF", "1", "yes"])
def test_use_fat_attention_reads_the_jax_switch(value, monkeypatch):
    from cbas_tpu.ops import flash_attention as jfa

    if value is None:
        monkeypatch.delenv("CBAS_ATTN_FAT", raising=False)
    else:
        monkeypatch.setenv("CBAS_ATTN_FAT", value)
    assert fa.use_fat_attention() == jfa.use_fat_attention()


def _card_tolerance(got, want, v, n_valid, N):
    """fp32: 2e-5 abs+rel (summation order). bf16: both round at the same
    points, but the kernel rounds p against a running max, so 2^-8 of the
    largest |v| plus one bf16 ulp (2^-7 relative) plus 1e-5."""
    if got.dtype == torch.float32:
        return TOL * (1 + want.float().abs())
    vmax = v[..., : n_valid or N, :].float().abs().max()
    return want.float().abs() * 2.0 ** -7 + 2.0 ** -8 * vmax + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,N,d,n_valid",
    [
        (2, 32, 261, 128, None),  # ViT-7B's heads at 256x256
        (1, 32, 1205, 128, None),  # and at 640x480
        (4, 3, 261, 64, None),     # an odd head count
        (2, 4, 272, 96, 261),      # a half not a power of two, pad keys masked
        (2, 4, 200, 40, 190),      # a head dim not a multiple of 16
        (2, 4, 272, 192, 261),     # heads wider than 128: the Hopper body in bf16
        (1, 2, 261, 256, None),    # the widest head K3 takes
        (1, 2, 140, 256, 130),     # the widest, pad keys masked
    ],
)
def test_headmajor_kernel_matches_plain_on_card(B, H, N, d, n_valid, dtype, cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt) for t in _inputs((B, H, N, d), seed=27))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=28))
    width = fa.headmajor_width(dt, d)  # fp32 at 40 and 96: the fp32 Hopper body at 64 / 128
    before = fa.launches_headmajor, fa.launches_headmajor_by_dim.get(width, 0)
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert (fa.launches_headmajor, fa.launches_headmajor_by_dim[width]) == (before[0] + 1,
                                                                           before[1] + 1)
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,N,d,n_valid",
    [
        (2, 4, 261, 100, None),  # at 128: bf16 staged (rows of 200 bytes), fp32 maps at d
        (2, 4, 272, 160, 261),   # at 192, pad keys masked
        (1, 2, 140, 60, 130),    # at 64: the Hopper body (bf16) or its fp32 counterpart
        (1, 2, 100, 12, None),   # at 64: bf16 staged
    ],
)
def test_padded_headmajor_kernel_matches_plain_on_card(B, H, N, d, n_valid, dtype, rope,
                                                       cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt) for t in _inputs((B, H, N, d), seed=44))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=45))
    width = fa.headmajor_width(dt, d)
    before = fa.launches_headmajor_by_dim.get(width, 0)
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert fa.launches_headmajor_by_dim[width] == before + 1
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert got.shape == (B, H, N, d) and bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (329, 300), (1205, None),
                                       (1216, 1205)])
@pytest.mark.parametrize("d", [192, 256, 200, 320, 384, 257, 301, 1040, 1100])
def test_redesigned_headmajor_bodies_match_plain_on_card(d, N, n_valid, rope, dtype, cuda_device):
    """K3's Hopper body at d 192 and its two-consumer body at 256 (200 runs
    at 256; in fp32 the fp32 Hopper body's wide form), and above 256 its
    wide body (bf16) and the
    fp32 slices body (257 and 301 odd:
    staged without the TMA, roped before the launch; 1040 and 1100 wider
    than a resident Q: Q streamed, 1100
    staged without the TMA), against the plain version, NaN in the dead K/V
    rows; the launch counters say which body ran."""
    dt = getattr(torch, dtype)
    B, H = (2, 4) if N < 1000 else (1, 3)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt) for t in _inputs((B, H, N, d), seed=53))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos = sin = None
    if rope:
        ang = np.random.default_rng(54).standard_normal((N, d)).astype(np.float32)
        cos, sin = (torch.from_numpy(f(ang)).to(cuda_device) for f in (np.cos, np.sin))
    width = fa.headmajor_width(dt, d)
    body = fa.attention_body("attention_headmajor", dt, width)
    bf16 = "sm90" if d <= 192 else "sm90_ws" if d <= 256 else "wide"
    assert body == (bf16 if dt == torch.bfloat16 else "sm90_f32_wide" if d <= 256
                    else "sm90_f32_slices")

    def counts():
        return (fa.launches_headmajor_by_dim.get(width, 0), fa.launches_sm90_ws, fa.launches_wide,
                fa.launches_sm90_f32_wide, fa.launches_sm90_f32_slices, fa.launches_sm90)

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + 1, before[1] + (body == "sm90_ws"),
                        before[2] + (body == "wide"), before[3] + (body == "sm90_f32_wide"),
                        before[4] + (body == "sm90_f32_slices"), before[5] + (body == "sm90"))
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert got.shape == (B, H, N, d) and bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


def _flat_and_pairs(B, G, N, seed, dtype, device="cpu", n_valid=None):
    """Flat (B, N, G*128) q, k, v from a numpy seed, NaN in the K/V rows at
    or beyond ``n_valid``, and their (B, G, N, 128) head-pair views (the
    packed route's operands: no copy)."""
    flat = [torch.from_numpy(t).to(device, dtype) for t in _inputs((B, N, G * 128), seed)]
    if n_valid is not None:
        for t in flat[1:]:
            t[:, n_valid:] = float("nan")
    return flat, [t.view(B, N, G, 128).transpose(1, 2) for t in flat]


@pytest.mark.parametrize("n_valid", [None, 61])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_views_equal_contiguous_copies(dtype, rope, n_valid):
    """K2 on head-pair views of flat tensors gives bit for bit what it gives
    on their contiguous copies, NaN in the dead K/V rows included, and
    returns the views' strides: the packed route's context goes back to
    (B, N, H*64) without a copy."""
    B, G, N = 2, 3, 70
    _, views = _flat_and_pairs(B, G, N, 33, dtype, n_valid=n_valid)
    assert not any(t.is_contiguous() for t in views)
    copies = [t.contiguous() for t in views]
    cos, sin = (torch.from_numpy(t) for t in _rope(N, 64, seed=34)) if rope else (None, None)
    got = fa.fused_attention_packed(*views, 0.125, n_valid, cos, sin)
    want = fa.fused_attention_packed(*copies, 0.125, n_valid, cos, sin)
    assert got.stride() == views[0].stride() and want.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert got.transpose(1, 2).reshape(B, N, G * 128).data_ptr() == got.data_ptr()


@pytest.mark.parametrize(
    "case,match",
    [
        ("last-dim stride 2", "stride 2"),
        ("misaligned stride", "stride 132 of dim 2 is not a multiple of 16 bytes"),
        ("different strides", "must share strides"),
        ("overlapping rows", "stride 64 of dim 2 overlaps"),
        ("misaligned base", "k2 starts at"),
    ],
)
def test_packed_wrapper_refuses_strides_the_kernel_does_not_take(case, match):
    """Each refusal names the stride (or address), on the CPU as on the card."""
    base = torch.zeros(1, 2, 16, 264, dtype=torch.bfloat16)
    q = base[..., :128]
    k = v = q
    if case == "last-dim stride 2":
        q = k = v = base[..., ::2][..., :128]
    elif case == "misaligned stride":
        q = k = v = base[..., :132].contiguous()[..., :128]  # rows of 264 bytes
    elif case == "different strides":
        k = q.contiguous()
    elif case == "overlapping rows":
        q = k = v = base.flatten()[: 2 * 16 * 64 + 128].as_strided((1, 2, 16, 128), (0, 16 * 64, 64, 1))
    elif case == "misaligned base":
        k = base.flatten()[4:].as_strided(q.shape, q.stride())  # 8 bytes in
    with pytest.raises(ValueError, match=match):
        fa.fused_attention_packed(q, k, v, 0.1)


def _flat_and_heads(B, H, N, d, seed, dtype, device="cpu", n_valid=None):
    """Flat (B, N, H*d) q, k, v from a numpy seed, NaN in the K/V rows at or
    beyond ``n_valid``, and their (B, H, N, d) head-major views (the
    head-major route's operands: no copy)."""
    flat = [torch.from_numpy(t).to(device, dtype) for t in _inputs((B, N, H * d), seed)]
    if n_valid is not None:
        for t in flat[1:]:
            t[:, n_valid:] = float("nan")
    return flat, [t.view(B, N, H, d).transpose(1, 2) for t in flat]


@pytest.mark.parametrize("d", [64, 128, 160, 200, 320, 330])
@pytest.mark.parametrize("n_valid", [None, 61])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_headmajor_views_equal_contiguous_copies(dtype, rope, n_valid, d):
    """K3 on head-major views of flat tensors gives bit for bit what it gives
    on their contiguous copies, NaN in the dead K/V rows included, and
    returns the views' strides: the head-major route's context goes back to
    (B, N, H*d) without a copy. (fp32 at 160 and 200 runs on maps at d
    since the fp32 Hopper bodies take those widths; at 330 a row is no
    16-byte multiple, so the strides need only be multiples of 4 bytes in
    bf16 and 8 in fp32, what the wide body's staged loads take.)"""
    B, H, N = 2, 3, 70
    _, views = _flat_and_heads(B, H, N, d, 35, dtype, n_valid=n_valid)
    assert not any(t.is_contiguous() for t in views)
    copies = [t.contiguous() for t in views]
    cos, sin = (torch.from_numpy(t) for t in _rope(N, d, seed=36)) if rope else (None, None)
    got = fa.fused_attention(*views, d ** -0.5, n_valid, cos, sin)
    want = fa.fused_attention(*copies, d ** -0.5, n_valid, cos, sin)
    assert want.is_contiguous() and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    if not fa.headmajor_in_place(dtype, d, rope):
        assert got.is_contiguous()
    else:
        assert got.stride() == views[0].stride()
        assert got.transpose(1, 2).reshape(B, N, H * d).data_ptr() == got.data_ptr()


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("B,H,N,d,n_valid", [(1, 3, 261, 64, None), (2, 2, 140, 128, 130),
                                              (1, 2, 80, 160, 70), (1, 2, 80, 200, None)])
def test_headmajor_views_match_jax(B, H, N, d, n_valid, rope):
    """The port's K3 on head-major views of flat tensors against the JAX
    kernel (interpret mode) on the same arrays, contiguous: fp32, the JAX
    suite's bounds."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    flat, views = _flat_and_heads(B, H, N, d, 37, torch.float32, n_valid=n_valid)
    cos, sin = _rope(N, d, seed=38) if rope else (None, None)
    want = np.asarray(jfa.fused_attention(
        *(jnp.asarray(t.contiguous().numpy()) for t in views), d ** -0.5, n_valid=n_valid,
        rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin), interpret=True,
    ))
    got = fa.fused_attention(*views, d ** -0.5, n_valid,
                             None if cos is None else torch.from_numpy(cos),
                             None if sin is None else torch.from_numpy(sin))
    assert np.isfinite(got.numpy()).all()
    tol = TOL_ROPE if rope else TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "case,match",
    [
        ("last-dim stride 2", "stride 2"),
        ("misaligned stride", "stride 132 of dim 2 is not a multiple of 16 bytes"),
        ("different strides", "must share strides"),
        ("overlapping rows", "stride 64 of dim 2 overlaps"),
        ("misaligned base", "k starts at"),
    ],
)
def test_headmajor_wrapper_refuses_strides_the_kernel_does_not_take(case, match):
    """K3 takes views under K2's rule, and names each refusal the same way,
    on the CPU as on the card."""
    base = torch.zeros(1, 2, 16, 264, dtype=torch.bfloat16)
    q = base[..., :128]
    k = v = q
    if case == "last-dim stride 2":
        q = k = v = base[..., ::2][..., :128]
    elif case == "misaligned stride":
        q = k = v = base[..., :132].contiguous()[..., :128]  # rows of 264 bytes
    elif case == "different strides":
        k = q.contiguous()
    elif case == "overlapping rows":
        q = k = v = base.flatten()[: 2 * 16 * 64 + 128].as_strided((1, 2, 16, 128), (0, 16 * 64, 64, 1))
    elif case == "misaligned base":
        k = base.flatten()[4:].as_strided(q.shape, q.stride())  # 8 bytes in
    with pytest.raises(ValueError, match=match):
        fa.fused_attention(q, k, v, 0.1)


@pytest.mark.parametrize("d,dtype", [(100, torch.bfloat16), (162, torch.float32), (13, torch.float32)])
def test_headmajor_copying_routes_take_any_strides(d, dtype):
    """The widths the card still copies first (fp32 not a multiple of 4, an
    odd d with tables) take strides the in-place rule refuses, here q, k and
    v with three different ones. bf16 copies at no width (d 100 goes through
    the staging launch in place): the in-place rule refuses those strides
    there, and takes one set of them at rows of 200 bytes."""
    B, H, N = 1, 2, 20
    flat, views = _flat_and_heads(B, H, N, d, 39, dtype)
    q, k, v = views[0], views[1].contiguous(), views[2][..., ::1]
    cos, sin = (torch.from_numpy(t) for t in _rope(N, d - d % 2, seed=40)) if d % 2 == 0 else (
        torch.ones(N, d), torch.zeros(N, d))
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="must share strides"):
            fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin)
        q, k, v = views
    got = fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin)
    want = fa.attention_headmajor_reference(*(t.contiguous() for t in (q, k, v)), d ** -0.5, None,
                                            cos, sin)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "view of flat"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,G,N,n_valid", [(4, 6, 261, None), (4, 6, 272, 261), (2, 6, 1205, None), (2, 6, 1216, 1205)]
)
def test_packed_kernel_matches_plain_on_card(B, G, N, n_valid, dtype, rope, layout, cuda_device):
    """K2 against its plain version on contiguous tensors and on head-pair
    views of flat ones, NaN in the dead K/V rows; bf16 runs the Hopper body
    (each call counts in launches_sm90), fp32 its fp32 counterpart (each call
    counts in launches_sm90_f32)."""
    dt = getattr(torch, dtype)
    _, (q, k, v) = _flat_and_pairs(B, G, N, 29, dt, cuda_device, n_valid)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, 64, seed=30))
    before, before_sm90 = fa.launches_packed, fa.launches_sm90
    before_f32 = fa.launches_sm90_f32
    got = fa.fused_attention_packed(q, k, v, 0.125, n_valid, cos, sin)
    assert fa.launches_packed == before + 1
    assert fa.launches_sm90 == before_sm90 + (dt == torch.bfloat16)
    assert fa.launches_sm90_f32 == before_f32 + (dt == torch.float32)
    assert got.stride() == q.stride()
    want = fa.attention_packed_reference(q, k, v, 0.125, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


@pytest.mark.parametrize(
    "kernel,dtype,d,body",
    [
        ("attention_fat", torch.bfloat16, 64, "sm90"),
        ("attention_fat", torch.float32, 64, "sm90_f32"),
        ("attention_headmajor", torch.bfloat16, 64, "sm90"),
        ("attention_headmajor", torch.bfloat16, 128, "sm90"),
        ("attention_headmajor", torch.float32, 128, "sm90_f32"),
        ("attention_headmajor", torch.bfloat16, 96, "sm90"),
        ("attention_headmajor", torch.bfloat16, 40, "sm90"),
        ("attention_packed", torch.bfloat16, 64, "sm90"),
        ("attention_packed", torch.float32, 64, "sm90_f32"),
        ("attention_headmajor", torch.bfloat16, 192, "sm90"),
        ("attention_headmajor", torch.bfloat16, 256, "sm90_ws"),
        ("attention_headmajor", torch.float32, 192, "sm90_f32_wide"),
        ("attention_headmajor", torch.float32, 256, "sm90_f32_wide"),
        ("attention_headmajor", torch.bfloat16, 257, "wide"),
        ("attention_headmajor", torch.bfloat16, 320, "wide"),
        ("attention_headmajor", torch.float32, 320, "sm90_f32_slices"),
        ("attention_headmajor", torch.float32, 384, "sm90_f32_slices"),
        ("attention_headmajor", torch.float32, 1000, "sm90_f32_slices"),
    ],
)
def test_attention_body_routing(kernel, dtype, d, body):
    """Which body an entry runs for (dtype, head dim), as the wrapper reports
    it without launching: the Hopper body for bf16 at d = 64 (every layout)
    and at every d up to 192 (head-major: 40 and 96 too, on maps at d), the
    two-consumer body for bf16 in K3 from 193 to 256, its
    fp32 counterpart for fp32 at d = 64 (every layout) and 128 (head-major),
    above 256 K3's wide body in bf16 and its fp32 slices body in fp32; no
    entry returns another body."""
    assert fa.attention_body(kernel, dtype, d) == body


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "sm90"), (torch.float32, "sm90_f32_wide")])
@pytest.mark.parametrize("d", [136, 160, 184, 192, 200, 232, 248, 256])
def test_widths_above_128_pad_onto_the_hopper_body_in_bf16(d, dtype, body):
    """A head from 136 to 256 runs, in bf16, at d rounded up to 32: the
    Hopper body's 160 and 192 and the two-consumer body's 224 and 256; in
    fp32 at 192 or 256, the fp32 wide form's; above 256 the wide body
    (bf16) or the fp32 slices body runs at d itself."""
    width = fa.headmajor_width(dtype, d)
    if dtype == torch.bfloat16:
        assert width == -(-d // 32) * 32
    else:
        assert width == (192 if d <= 192 else 256)
    want = "sm90_ws" if dtype == torch.bfloat16 and width > 192 else body
    assert fa.attention_body("attention_headmajor", dtype, width) == want
    above = "wide" if dtype == torch.bfloat16 else "sm90_f32_slices"
    assert fa.headmajor_width(dtype, d + 256) == d + 256
    assert fa.attention_body("attention_headmajor", dtype, d + 256) == above


def test_cpu_tensors_never_count_as_hopper_launches():
    before = fa.launches_sm90
    fa.fused_attention_fat(*(torch.zeros(1, 16, 128, dtype=torch.bfloat16) for _ in range(3)), 0.1)
    fa.fused_attention(*(torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16) for _ in range(3)), 0.1)
    fa.fused_attention_packed(
        *(torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16) for _ in range(3)), 0.1)
    assert fa.launches_sm90 == before


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (1205, None), (1216, 1205)])
@pytest.mark.parametrize("layout,H,d", [("flat", 12, 64), ("head-major", 3, 64), ("head-major", 8, 128)])
def test_hopper_body_matches_plain_on_card(layout, H, d, N, n_valid, rope, cuda_device):
    """The Hopper body (bf16 at d = 64 and 128) against the plain version,
    NaN in the dead K/V rows; each call is counted as a launch through it."""
    shape = (1, N, H * d) if layout == "flat" else (1, H, N, d)
    q, k, v = (torch.from_numpy(t).to(cuda_device, torch.bfloat16) for t in _inputs(shape, seed=31))
    token_dim = 1 if layout == "flat" else 2
    if n_valid is not None:
        dead = (slice(None),) * token_dim + (slice(n_valid, None),)
        k[dead] = float("nan")
        v[dead] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=32))
    entry, plain = ((fa.fused_attention_fat, fa.attention_fat_reference) if layout == "flat"
                    else (fa.fused_attention, fa.attention_headmajor_reference))
    before = fa.launches_sm90
    got = entry(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert fa.launches_sm90 == before + 1
    want = plain(q, k, v, d ** -0.5, n_valid, cos, sin)
    live = (slice(None),) * token_dim + (slice(0, n_valid or N),)
    vmax = v[live].float().abs().max()
    tol = want.float().abs() * 2.0 ** -7 + 2.0 ** -8 * vmax + 1e-5
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (329, 300), (1205, None)])
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 330])
def test_headmajor_views_match_plain_on_card(d, N, n_valid, rope, dtype, cuda_device):
    """K3 on head-major views of flat tensors (the head-major route's
    operands) against its plain version, NaN in the dead K/V rows, and bit
    for bit against itself on their contiguous copies; the output keeps the
    views' strides, each call one launch at d (330: the wide body's staged
    loads, rows no 16-byte multiple)."""
    dt = getattr(torch, dtype)
    B, H = (2, 4) if N < 1000 else (1, 3)
    _, views = _flat_and_heads(B, H, N, d, 55, dt, cuda_device, n_valid)
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=56))
    before = fa.launches_headmajor_by_dim.get(d, 0)
    got = fa.fused_attention(*views, d ** -0.5, n_valid, cos, sin)
    assert fa.launches_headmajor_by_dim[d] == before + 1
    assert got.stride() == views[0].stride()
    want = fa.attention_headmajor_reference(*views, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, views[2], n_valid, N)).all()), float(err.max())
    copies = fa.fused_attention(*(t.contiguous() for t in views), d ** -0.5, n_valid, cos, sin)
    assert torch.equal(got, copies)


def _cuda_kernels(torch_mod, fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` ran, from a
    ``torch.profiler`` trace (``chip_smoke.trace_kernels``: on the card's
    machine a trace may lose its events, so an empty one is taken again)."""
    import chip_smoke

    return chip_smoke.trace_kernels(torch_mod, fn)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "view of flat"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (1205, None)])
@pytest.mark.parametrize("d", [136, 160, 200, 248])
def test_map_padded_widths_run_without_copies_on_card(d, N, n_valid, rope, layout, cuda_device):
    """bf16 heads of the multiples of 8 from 136 to 248 run on the body of
    the next built width (the Hopper body at 160, 160 its own; the
    two-consumer body at 224 and 256) with no pad or slice: read in place
    (160; 200 and 248, rows off a 32-byte boundary on the two-consumer
    body) one kernel a call without RoPE and two with (the RoPE prologue,
    then the attention kernel), staged (136: a row off a 32-byte boundary
    below 193) two, the staging pass then the attention kernel, by the
    counters and by a profiler trace; against the plain version, NaN in the
    dead K/V rows."""
    B, H = (2, 4) if N < 1000 else (1, 3)
    _, views = _flat_and_heads(B, H, N, d, 57, torch.bfloat16, cuda_device, n_valid)
    q, k, v = views if layout == "view of flat" else [t.contiguous() for t in views]
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=58))
    width = fa.headmajor_width(torch.bfloat16, d)
    assert width == {136: 160, 160: 160, 200: 224, 248: 256}[d]

    def counts():
        body = fa.attention_body("attention_headmajor", torch.bfloat16, width)
        return fa.launches_headmajor_by_dim.get(width, 0), getattr(fa, f"launches_{body}")

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + 1, before[1] + 1)
    assert got.shape == (B, H, N, d) and got.stride() == q.stride()
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())
    kernels = _cuda_kernels(torch, lambda: fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin))
    staged = fa.headmajor_staged(torch.bfloat16, d, rope)
    assert staged == (d == 136)
    assert len(kernels) == (2 if staged else 1 + rope), kernels
    assert sum("attention_sm90" in name for name in kernels) == 1, kernels
    assert sum("rope_rows" in name for name in kernels) == (rope and not staged), kernels
    assert sum("stage_rows" in name for name in kernels) == staged, kernels
