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
    q = torch.zeros(1, 2, 16, 136)
    with pytest.raises(ValueError, match="up to 128"):
        fa.fused_attention(q, q, q, 0.1)
    q = torch.zeros(1, 2, 16, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.fused_attention(q, q, q, 0.1)
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
    before = (fa.launches, fa.launches_packed, fa.launches_headmajor)
    q = torch.zeros(1, 2, 16, 128)
    fa.fused_attention(q, q, q, 0.1)
    fa.fused_attention_packed(q, q, q, 0.1)
    assert (fa.launches, fa.launches_packed, fa.launches_headmajor) == before


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
    ],
)
def test_headmajor_kernel_matches_plain_on_card(B, H, N, d, n_valid, dtype, cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt) for t in _inputs((B, H, N, d), seed=27))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, d, seed=28))
    before = fa.launches_headmajor
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert fa.launches_headmajor == before + 1
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
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
    (each call counts in launches_sm90), fp32 the common one."""
    dt = getattr(torch, dtype)
    _, (q, k, v) = _flat_and_pairs(B, G, N, 29, dt, cuda_device, n_valid)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t).to(cuda_device) for t in _rope(N, 64, seed=30))
    before, before_sm90 = fa.launches_packed, fa.launches_sm90
    got = fa.fused_attention_packed(q, k, v, 0.125, n_valid, cos, sin)
    assert fa.launches_packed == before + 1
    assert fa.launches_sm90 == before_sm90 + (dt == torch.bfloat16)
    assert got.stride() == q.stride()
    want = fa.attention_packed_reference(q, k, v, 0.125, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())


@pytest.mark.parametrize(
    "kernel,dtype,d,body",
    [
        ("attention_fat", torch.bfloat16, 64, "sm90"),
        ("attention_fat", torch.float32, 64, "common"),
        ("attention_headmajor", torch.bfloat16, 64, "sm90"),
        ("attention_headmajor", torch.bfloat16, 128, "sm90"),
        ("attention_headmajor", torch.float32, 128, "common"),
        ("attention_headmajor", torch.bfloat16, 96, "common"),
        ("attention_headmajor", torch.bfloat16, 40, "common"),
        ("attention_packed", torch.bfloat16, 64, "sm90"),
        ("attention_packed", torch.float32, 64, "common"),
    ],
)
def test_attention_body_routing(kernel, dtype, d, body):
    """Which body an entry runs for (dtype, head dim), as the wrapper reports
    it without launching: the Hopper body for bf16 at d = 64 (every layout)
    and 128 (head-major), the common body otherwise."""
    assert fa.attention_body(kernel, dtype, d) == body


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
