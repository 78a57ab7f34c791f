"""K3 in bfloat16 at every head dim: the routing, the staging pass's plain
version and the plain K3 against the JAX package's, on the CPU.

Every bf16 head of width d up to 192 runs the Hopper body
(``csrc/attention_sm90.cuh``) at the next of 64, 128 and 192, and every one
from 193 to 256 the two-consumer body (``csrc/attention_sm90_ws.cuh``) at
256, with their tensor maps at d, in place: no pad copy and no RoPE in
torch. A row of d
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
# Then the two-consumer body's widths with RoPE: 200 (staged) and 256.
JAX_CASES = [(1, 2, 80, d, 70, rope) for d in (32, 96, 100, 150) for rope in (False, True)] + [
    (1, 2, 80, 65, 70, True), (1, 2, 80, 200, 70, True), (1, 2, 80, 256, 70, True)]


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
    """d 1-300: up to 192 the Hopper body at the next of 64, 128 and 192,
    from 193 to 256 the two-consumer body at 256, above 256 the wide body
    at d; every width in place (no pad copy, no RoPE in torch), with tables
    and without."""
    for d in range(1, 301):
        width = fa.headmajor_width(BF16, d)
        assert width == (_built(d) if d <= 256 else d), d
        body = "sm90" if d <= 192 else "sm90_ws" if d <= 256 else "wide"
        assert fa.attention_body("attention_headmajor", BF16, width) == body, d
        assert fa.attention_body("attention_headmajor", BF16, d) == body, d
        assert fa.headmajor_in_place(BF16, d, rope), d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_entry_names_a_body_outside_the_five(dtype):
    """``attention_body`` returns one of the six bodies the C entries
    report, or raises for what no entry takes (K1 and K2 off d 64); the
    common body is gone."""
    bodies = set(fa._BODIES.values())
    assert bodies == {"sm90", "sm90_ws", "wide", "sm90_f32", "sm90_f32_wide", "sm90_f32_slices"}
    for kernel in KERNELS:
        for d in range(1, 301):
            if kernel != "attention_headmajor" and d != fa.HEAD_DIM:
                with pytest.raises(ValueError, match="takes no head dim"):
                    fa.attention_body(kernel, dtype, d)
                continue
            assert fa.attention_body(kernel, dtype, d) in bodies, (kernel, d)
    with pytest.raises(ValueError, match="no attention body"):
        fa.attention_body("attention_headmajor", torch.float16, 64)


@pytest.mark.parametrize("d", [136, 160, 192, 200, 248, 256])
def test_bf16_k3_from_129_to_256_routes_by_the_measured_rule(d):
    """K3's bf16 heads from 129 to 192 keep the Hopper body at 192, those
    from 193 to 256 take the two-consumer body at 256 (by their width and by
    the width they run at); fp32 keeps its wide form at both."""
    width = fa.headmajor_width(BF16, d)
    assert width == (192 if d <= 192 else 256)
    body = "sm90" if d <= 192 else "sm90_ws"
    assert fa.attention_body("attention_headmajor", BF16, d) == body
    assert fa.attention_body("attention_headmajor", BF16, width) == body
    assert fa.attention_body("attention_headmajor", torch.float32, width) == "sm90_f32_wide"
    assert fa.headmajor_staged(BF16, d) == (d % 16 != 0)


@pytest.mark.parametrize("kernel,d", [("attention_fat", 64), ("attention_packed", 64),
                                      ("attention_headmajor", 32), ("attention_headmajor", 64),
                                      ("attention_headmajor", 96), ("attention_headmajor", 100),
                                      ("attention_headmajor", 128)])
def test_bf16_up_to_128_and_k1_k2_keep_the_hopper_body(kernel, d):
    """K1, K2 and K3's bf16 heads up to 128 keep the one-warpgroup Hopper
    body."""
    assert fa.attention_body(kernel, BF16, d) == "sm90"


def test_two_consumer_launches_count_apart(monkeypatch):
    """A K3 launch through the two-consumer body counts under its own
    counter (and its staging launch under the staging pass's), never under
    the Hopper body's."""
    for name in ("launches_stage", "launches_sm90", "launches_sm90_ws", "launches_headmajor"):
        monkeypatch.setattr(fa, name, 0)
    monkeypatch.setattr(fa, "launches_headmajor_by_dim", {})
    monkeypatch.setattr(fa, "launches_sm90_by_kernel", {})
    fa._count_launch("attention_headmajor", 256, "sm90_ws", 1)
    fa._count_launch("attention_headmajor", 256, "sm90_ws", 0)
    fa._count_launch("attention_headmajor", 192, "sm90", 0)
    assert (fa.launches_sm90_ws, fa.launches_sm90, fa.launches_stage,
            fa.launches_headmajor) == (2, 1, 1, 3)
    assert fa.launches_headmajor_by_dim == {256: 2, 192: 1}
    assert fa._BODIES[6] == "sm90_ws" and fa.BF16_BODIES == ("sm90", "sm90_ws")


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
    one K3 launch through the Hopper body (the two-consumer body from 193 to
    256, the wide body above), a staging launch where a row is no 32-byte
    multiple (above 256: at an odd d with tables), no copy kernel, the
    output dense in q's dim order."""
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
    body = "sm90" if d <= 192 else "sm90_ws" if d <= 256 else "wide"
    assert fa.attention_body("attention_headmajor", BF16, width) == body
    staged = fa.headmajor_staged(BF16, d, rope)
    assert staged == (d % 16 != 0 if d <= 256 else (rope and d % 2 == 1))

    def counts():
        return (fa.launches_headmajor_by_dim.get(width, 0), fa.launches_sm90, fa.launches_wide,
                fa.launches_stage, fa.launches_sm90_ws)

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + 1, before[1] + (body == "sm90"),
                        before[2] + (body == "wide"), before[3] + staged,
                        before[4] + (body == "sm90_ws"))
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


# The two-consumer body's set: 136 and 200 staged, 160 on maps at d below its
# width, 192 and 256 at theirs; N 261 and 1205, and 272 / 261 and 1216 / 1205
# with NaN in the dead rows. K3 runs 193-256 on it and 129-192 on the Hopper
# body (the measured rule).
WS_CARD_DIMS = (136, 160, 192, 200, 256)
WS_CARD_ROWS = [(261, None), (272, 261), (1205, None), (1216, 1205)]


def _card_heads(B, H, N, d, n_valid, layout, seed, device):
    """Head-major bf16 q, k, v on ``device``, contiguous or (``layout``
    "fused views") views of one fused (B, N, 3*H*d) projection, NaN in the
    K/V rows from ``n_valid``."""
    rng = np.random.default_rng(seed)
    if layout == "fused views":
        qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d), np.float32)).to(
            device, BF16)
        q, k, v = (qkv[..., j * H * d:(j + 1) * H * d].view(B, N, H, d).transpose(1, 2)
                   for j in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d), np.float32)).to(
            device, BF16) for _ in range(3))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused views"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", WS_CARD_ROWS)
@pytest.mark.parametrize("d", WS_CARD_DIMS)
def test_two_consumer_body_matches_plain_on_card(d, N, n_valid, rope, layout, cuda_device):
    """K3 in bf16 at the two-consumer body's set against the plain version
    within ``_card_tolerance``, NaN in the dead K/V rows, on contiguous
    tensors and on head-major views of one fused projection (the same bits
    on both): one launch a call through the body the rule routes d to (the
    two-consumer body from 193 to 256, the Hopper body below), none through
    the other, and one staging launch with it at d % 16 != 0."""
    B, H = (2, 3) if N < 1000 else (1, 3)
    q, k, v = _card_heads(B, H, N, d, n_valid, layout, 72, cuda_device)
    cos = sin = None
    if rope:
        cos, sin = (t.to(cuda_device) for t in _tables(N, d, seed=73))
    body = fa.attention_body("attention_headmajor", BF16, d)
    assert body == ("sm90_ws" if d > 192 else "sm90")
    staged = fa.headmajor_staged(BF16, d, rope)

    def counts():
        return fa.launches_sm90_ws, fa.launches_sm90, fa.launches_stage

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + (body == "sm90_ws"), before[1] + (body == "sm90"),
                        before[2] + staged)
    assert got.shape == (B, H, N, d) and got.stride() == fa._dense_like(q).stride()
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())
    copies = [t.contiguous() for t in (q, k, v)]
    assert torch.equal(got, fa.fused_attention(*copies, d ** -0.5, n_valid, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused views"])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (1216, 1205)])
@pytest.mark.parametrize("d", [96, 128])
def test_two_consumer_timing_entry_matches_plain_on_card(d, N, n_valid, rope, layout,
                                                         cuda_device):
    """The two-consumer body built at 128 (``attention_variants.ws_attention``,
    a timing case no route calls) against the plain version within
    ``_card_tolerance``, at d 128 and on maps at d below it (96), NaN in the
    dead K/V rows, the same bits on views of one fused projection as on
    contiguous copies, one launch of its own counter a call."""
    from cbas_tpu_torch.ops import attention_variants as av

    B, H = (2, 3) if N < 1000 else (1, 3)
    q, k, v = _card_heads(B, H, N, d, n_valid, layout, 76, cuda_device)
    cos = sin = None
    if rope:
        cos, sin = (t.to(cuda_device) for t in _tables(N, d, seed=77))
    before = av.launches_ws
    got = av.ws_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert av.launches_ws == before + 1
    assert got.shape == (B, H, N, d) and got.stride() == fa._dense_like(q).stride()
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= _card_tolerance(got, want, v, n_valid, N)).all()), float(err.max())
    copies = [t.contiguous() for t in (q, k, v)]
    assert torch.equal(got, av.ws_attention(*copies, d ** -0.5, n_valid, cos, sin))


def test_ws_attention_on_the_cpu_and_its_refusals():
    """The two-consumer body's timing entry (``attention_variants.
    ws_attention``, which no route calls) is the plain K3 on CPU tensors at
    the widths its build at 128 takes on maps at d (80-128 in steps of 16);
    it refuses rows that would need the staging pass, widths outside those,
    and fp32."""
    from cbas_tpu_torch.ops import attention_variants as av

    q, k, v = _inputs((1, 2, 40, 128), seed=74)
    cos, sin = _tables(40, 128, seed=75)
    want = fa.attention_headmajor_reference(q, k, v, 0.1, 33, cos, sin)
    assert torch.equal(av.ws_attention(q, k, v, 0.1, 33, cos, sin), want)
    narrow = [t[..., :96] for t in (q, k, v)]  # maps at d below the width
    assert torch.equal(av.ws_attention(*narrow, 0.1, 33),
                       fa.attention_headmajor_reference(*narrow, 0.1, 33))
    for d in (64, 100, 136):  # below the width's range, rows of 200 bytes, above 128
        q2, k2, v2 = _inputs((1, 2, 40, d), seed=78)
        with pytest.raises(ValueError, match="timing entry takes"):
            av.ws_attention(q2, k2, v2, 0.1)
    with pytest.raises(ValueError, match="bf16"):
        av.ws_attention(*(t.float() for t in (q, k, v)), 0.1)


def test_chip_smoke_names_the_two_consumer_kernels():
    """``chip_smoke.py``'s labels, ptxas lookup and ptxas record know the
    two-consumer body: its head dim, map rank and staged form, and ptxas's
    registers at entry, spills and "setmaxnreg ignored" warning for each
    build, raising on a spill or that warning."""
    import chip_smoke

    stem = ("_ZN14cbas_attention7sm90_ws17attention_sm90_wsILi{}ELi{}ELb{}EEEv14CUtensorMap"
            "_stS2_S2_S2_PKfS4_iifNS_4sm9010MapAddressENS5_8PlainOutE")
    assert chip_smoke.kernel_label(stem.format(256, 4, 0)) == "sm90_ws<256, 4>"
    assert chip_smoke.kernel_label(stem.format(256, 5, 0)) == "sm90_ws<256, 5>"
    assert chip_smoke.kernel_label(stem.format(256, 4, 1)) == "sm90_ws<256, 4, staged>"
    assert chip_smoke.kernel_label(stem.format(128, 4, 0)) == "sm90_ws<128, 4>"
    log = (f"ptxas warning : (C7508) Potential Performance Loss: setmaxnreg ignored; unable to "
           f"determine register count at entry for function '{stem.format(256, 4, 0)}'\n"
           f"ptxas info    : Compiling entry function '{stem.format(256, 4, 0)}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_report(log) == ["sm90_ws<256, 4>: 168 regs, 0/0 spill, "
                                            "setmaxnreg ignored"]
    saved = dict(chip_smoke.PTXAS)
    reports = {"sm90_ws<256, 4>": "168 regs, 0/0 spill", "sm90_ws<256, 4, staged>":
               "168 regs, 0/0 spill", "sm90<192, 4>": "158 regs, 0/0 spill"}
    chip_smoke.PTXAS.clear()
    chip_smoke.PTXAS["attention_headmajor"] = reports
    try:
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, 256) == "168 regs, 0/0 spill"
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, 248) == \
            reports["sm90_ws<256, 4, staged>"]
        assert chip_smoke.kernel_ptxas(fa, "attention_headmajor", BF16, 160) == \
            reports["sm90<192, 4>"]
        assert chip_smoke.ws_registers() == {
            f"attention_headmajor: {label}": {"registers_at_entry": 168, "spill_stores": 0,
                                              "spill_loads": 0, "setmaxnreg_ignored": False}
            for label in ("sm90_ws<256, 4>", "sm90_ws<256, 4, staged>")}
        reports["sm90_ws<256, 4>"] = "168 regs, 0/0 spill, setmaxnreg ignored"
        with pytest.raises(AssertionError, match="ptxas"):
            chip_smoke.ws_registers()
        reports["sm90_ws<256, 4>"] = "168 regs, 8/8 spill"
        with pytest.raises(AssertionError, match="ptxas"):
            chip_smoke.ws_registers()
    finally:
        chip_smoke.PTXAS.clear()
        chip_smoke.PTXAS.update(saved)


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
