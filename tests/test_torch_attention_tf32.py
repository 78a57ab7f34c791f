"""The fp32 Hopper body's arithmetic ("3xTF32") against the JAX package's
kernels and an fp64 oracle, on the CPU.

``csrc/attention_sm90_tf32.cuh`` computes K1, K2 and K3 in float32 at head
dims 64 and 128 on the tensor cores: every fp32 operand is split into two
TF32 values (``fa.tf32_split``) and every product is summed as
lo.hi + hi.lo + hi.hi in fp32. A CUDA kernel has no CPU mode, so these
tests hold a plain emulation of that arithmetic (:func:`emulate`: the
prologue's split K and permuted V^T planes, Q split in the block, the
three products of each operand pair added as the tensor core adds them,
truncating, into the body's accumulators, K and V tile by tile with the
online softmax, P split before p.V) against the JAX kernels in
Pallas interpret mode, as their own tests run them, within 2e-5 (atol and
rtol: the JAX suite's bound for these kernels in fp32), and against an
fp64 oracle within ``validate_kernels.CARD_TOL_F32`` (5e-6, the bound the
card's kernels are held to), and the body's split accumulators against one
chained accumulator. Then the split itself over fp32 bit patterns
(hypothesis), the prologue's plain version (``fa.tf32_prologue_reference``,
which the card's prologue matches bit for bit), the key order of V^T
against the wgmma fragment layouts, and the routing. Inputs come from numpy
seeds.

The ``cuda`` tests hold the kernel against its plain version and skip
without a card. This file imports jax only inside the JAX-parity tests:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_tf32.py
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cbas_tpu_torch.ops import flash_attention as fa
from cbas_tpu_torch.tools.validate_kernels import CARD_TOL_F32

TOL = 2e-5
MASKED = -1e30  # the kernels' masked-score value


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _rope_tables(N, d, seed):
    """(N, d) cos and sin tables of rotate-half RoPE: tiled halves of
    random angles, as the JAX suite builds them."""
    ang = np.random.default_rng(seed).standard_normal((N, d // 2)).astype(np.float32)
    return (np.concatenate([np.cos(ang)] * 2, axis=-1),
            np.concatenate([np.sin(ang)] * 2, axis=-1))


def _roped(x, cos, sin):
    """x * cos + rotate_half(x) * sin in fp32, each product and the sum
    rounded apart, as the kernels and the plain versions compute it."""
    return x * cos + fa.rotate_half(x) * sin


def _rz(x):
    """fp64 ``x`` rounded to fp32 toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core(acc, terms):
    """``acc`` + the sum of ``terms`` as wgmma adds them: each term one
    8-deep k-step (a, b) of TF32 values, a . b^T; its products are exact in
    fp32, their sum is taken exactly (fp64) and added to the fp32
    accumulator, rounding toward zero (the tensor core truncates where it
    aligns and adds). ``acc`` None: the first term does not read it."""
    for a, b in terms:
        x = a.double() @ b.double().transpose(-1, -2)
        acc = _rz(x if acc is None else x + acc.double())
    return acc


def _k_steps(a, b):
    """a . b^T as 8-deep k-steps, in order."""
    return [(a[..., j:j + 8], b[..., j:j + 8]) for j in range(0, a.shape[-1], 8)]


def _small_then_large(a_hi, a_lo, b_hi, b_lo):
    """The body's issue order of a product's wgmmas: lo.hi and hi.lo of each
    k-step in turn, then hi.hi over every k-step."""
    small = [t for lh, hl in zip(_k_steps(a_lo, b_hi), _k_steps(a_hi, b_lo)) for t in (lh, hl)]
    return small, _k_steps(a_hi, b_hi)


def emulate(q, k, v, scale, n_valid=None, cos=None, sin=None, chained=False):
    """The fp32 Hopper body's arithmetic on head-major (B, H, N, d) fp32
    tensors, in fp32: the prologue's planes (its plain version), Q roped,
    scaled and split, then per key tile S = Q K^T in three products, the
    dead keys masked by select, the online softmax (running max, exp, the
    rescale of O and of the row sum), P split and P V in three products
    with V read from the permuted V^T planes; O / row sum. Every wgmma sum
    is :func:`_tensor_core`'s. The body's accumulators: q.k^T's small
    products in one, its large in another, added in fp32; each tile's p.V
    in its own, added to O alpha by an fp32 FMA. ``chained``: one
    accumulator for all three products of q.k^T, and O itself the
    accumulator of every tile's p.V (rescaled by alpha in fp32 between
    tiles), the design the split replaced."""
    B, H, N, d = q.shape
    nv = N if n_valid is None else n_valid
    tile = fa.TF32_KEY_TILE
    planes = fa.tf32_prologue_reference(k, v, nv, cos, sin)
    n_keys = planes.shape[3]
    k_hi, k_lo = planes[0], planes[1]
    vt_hi = planes[2].reshape(B, H, d, n_keys)
    vt_lo = planes[3].reshape(B, H, d, n_keys)
    qh = q.float()
    if cos is not None:
        qh = _roped(qh, cos, sin)
    q_hi, q_lo = fa.tf32_split(qh * scale)
    # The permuted position of each key within its tile's V^T columns.
    pos = torch.tensor([8 * (i // 8) + fa.TF32_KEY_ORDER.index(i % 8) for i in range(tile)])
    o = torch.zeros(B, H, N, d)
    m = torch.full((B, H, N, 1), -torch.inf)
    l = torch.zeros(B, H, N, 1)
    for k0 in range(0, n_keys, tile):
        ks = slice(k0, k0 + tile)
        small, large = _small_then_large(q_hi, q_lo, k_hi[:, :, ks], k_lo[:, :, ks])
        if chained:
            s = _tensor_core(None, small + large)
        else:
            s = _tensor_core(None, large) + _tensor_core(None, small)
        live = torch.arange(k0, k0 + tile) < nv
        s = torch.where(live, s, MASKED)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mx
        p_hi, p_lo = fa.tf32_split(p)
        # V^T's columns of this tile, back in key order: position pos[j] holds key j.
        v_hi = vt_hi[..., ks][..., pos]
        v_lo = vt_lo[..., ks][..., pos]
        small, large = _small_then_large(p_hi, p_lo, v_hi, v_lo)
        if chained:
            o = _tensor_core(o * alpha, small + large)
        else:
            pv = _tensor_core(None, small + large)
            o = (o.double() * alpha.double() + pv.double()).float()  # one fp32 FMA
    return o / l


def _oracle(q, k, v, scale, n_valid, cos, sin):
    """Attention in fp64 over the live keys, q and k roped in fp32 first (as
    validate_kernels' oracle)."""
    nv = q.shape[2] if n_valid is None else n_valid
    if cos is not None:
        q, k = _roped(q, cos, sin), _roped(k, cos, sin)
    q, k, v = (t.double() for t in (q, k[:, :, :nv], v[:, :, :nv]))
    return torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v


def _heads_of(layout, t, H):
    """A kernel operand as head-major (B, H, N, d) and back."""
    if layout == "fat":
        B, N, _ = t.shape
        return t.reshape(B, N, H, 64).transpose(1, 2)
    if layout == "packed":
        B, G, N, _ = t.shape
        return t.reshape(B, G, N, 2, 64).transpose(2, 3).reshape(B, 2 * G, N, 64)
    return t


def _jax_kernel(layout, q, k, v, scale, n_valid, cos, sin):
    """The JAX kernel of ``layout`` in interpret mode, head-major in and out."""
    jnp = pytest.importorskip("jax.numpy")
    from cbas_tpu.ops import flash_attention as jfa

    B, H, N, d = q.shape
    to_layout = {
        "fat": lambda t: t.transpose(1, 2).reshape(B, N, H * d),
        "packed": lambda t: t.reshape(B, H // 2, 2, N, d).transpose(2, 3).reshape(B, H // 2, N, 2 * d),
        "headmajor": lambda t: t,
    }[layout]
    entry = {"fat": jfa.fused_attention_fat, "packed": jfa.fused_attention_packed,
             "headmajor": jfa.fused_attention}[layout]
    out = entry(*(jnp.asarray(to_layout(t).contiguous().numpy()) for t in (q, k, v)), scale,
                n_valid=n_valid,
                rope_cos=None if cos is None else jnp.asarray(cos.numpy()),
                rope_sin=None if sin is None else jnp.asarray(sin.numpy()), interpret=True)
    return _heads_of(layout, torch.from_numpy(np.array(out)), H)


def _case(H, N, d, n_valid, rope, seed):
    """q, k, v head-major (1, H, N, d) fp32 from a numpy seed, NaN in the
    dead K/V rows, and the tables (or None)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, H, N, d)).astype(np.float32))
               for _ in range(3))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    cos = sin = None
    if rope:
        cos, sin = (torch.from_numpy(t) for t in _rope_tables(N, d, seed + 1))
    return q, k, v, cos, sin


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261)])
@pytest.mark.parametrize("layout,d", [("fat", 64), ("packed", 64), ("headmajor", 64),
                                      ("headmajor", 128)])
def test_emulated_3xtf32_matches_jax_and_fp64(layout, d, N, n_valid, rope):
    """The emulated body against the JAX kernel of each layout it serves
    (K1, K2, K3 at 64; K3 at 128) within 2e-5, and against fp64 within
    CARD_TOL_F32; NaN in the dead rows stays out."""
    q, k, v, cos, sin = _case(2, N, d, n_valid, rope, seed=70 + d + N)
    scale = d ** -0.5
    got = emulate(q, k, v, scale, n_valid, cos, sin)
    assert bool(torch.isfinite(got).all())
    want = _jax_kernel(layout, q, k, v, scale, n_valid, cos, sin)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    err = (got.double() - _oracle(q, k, v, scale, n_valid, cos, sin)).abs().max()
    assert float(err) < CARD_TOL_F32, float(err)


@pytest.mark.parametrize("N,n_valid", [(1205, None), (1216, 1205)])
def test_emulated_3xtf32_at_480p_tokens_within_card_tolerance(N, n_valid):
    """At 640x480's 1205 tokens, with the model's kind of tables: within
    CARD_TOL_F32 of fp64."""
    q, k, v, cos, sin = _case(2, N, 64, n_valid, True, seed=90)
    got = emulate(q, k, v, 0.125, n_valid, cos, sin)
    err = (got.double() - _oracle(q, k, v, 0.125, n_valid, cos, sin)).abs().max()
    assert float(err) < CARD_TOL_F32, float(err)


@pytest.mark.parametrize("N,n_valid", [(1205, None), (1216, 1205)])
def test_split_accumulators_keep_the_truncation_error_down(N, n_valid):
    """Why the body gives q.k^T's small products and each tile's p.V
    accumulators of their own: the tensor core truncates each add, so with
    one chained accumulator (O through every tile's p.V, 456 adds at 1216
    keys) the error against fp64 grows with N, to several times the split
    form's at 640x480's tokens. The split form stays below 1.5e-6 there."""
    q, k, v, cos, sin = _case(2, N, 64, n_valid, True, seed=90)
    want = _oracle(q, k, v, 0.125, n_valid, cos, sin)
    split, chained = (float((emulate(q, k, v, 0.125, n_valid, cos, sin, chained=c).double()
                             - want).abs().max()) for c in (False, True))
    assert split < 1.5e-6, split
    assert chained > 5 * split, (split, chained)


def test_emulated_3xtf32_beats_one_tf32_product():
    """The two small products are what buys fp32 accuracy: the same
    emulation with hi.hi alone is far outside CARD_TOL_F32."""
    q, k, v, _, _ = _case(2, 261, 64, None, False, seed=91)
    hi = lambda t: fa.tf32_split(t)[0]  # noqa: E731
    s = hi(q * 0.125) @ hi(k).transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    one = hi(p) @ hi(v)
    err_one = (one.double() - _oracle(q, k, v, 0.125, None, None, None)).abs().max()
    err_three = (emulate(q, k, v, 0.125).double() - _oracle(q, k, v, 0.125, None, None, None)).abs().max()
    assert float(err_three) < CARD_TOL_F32 < float(err_one)


def _f32(bits):
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]


# Normal fp32 whose split stays in the normal range: x - hi is at least one
# ulp of x when not 0, so |x| >= 2^-100 keeps lo normal; |x| < 2^127 keeps
# hi finite (a value within half a TF32 ulp of 2^128 rounds to infinity, as
# cvt.rna.tf32.f32 does).
_NORMAL_BITS = st.integers(0, 1).flatmap(lambda sign: st.integers(
    (127 - 100) << 23, (127 + 126) << 23 | 0x7FFFFF).map(lambda m: sign << 31 | m))


@settings(max_examples=2000, deadline=None)
@given(_NORMAL_BITS)
def test_split_tf32_over_fp32_bit_patterns(bits):
    """hi and lo are TF32 values (the low 13 bits zero), hi + lo is exact in
    fp32, and |x - hi - lo| <= 2^-22 |x|."""
    x = torch.tensor([_f32(bits)], dtype=torch.float32)
    hi, lo = fa.tf32_split(x)
    for part in (hi, lo):
        assert int(part.view(torch.int32)[0]) & 0x1FFF == 0
    exact = hi.double() + lo.double()
    assert float((hi + lo).double()[0]) == float(exact[0])
    assert abs(float(x.double()[0] - exact[0])) <= 2.0 ** -22 * abs(float(x[0]))


def test_split_tf32_rounds_to_nearest_ties_away():
    """The split's hi is round to nearest, ties away from zero, at 10
    fraction bits: halfway cases go away from zero in both signs."""
    one = 0x3F800000
    for sign in (0, 1 << 31):
        half_up = torch.tensor([_f32(sign | one | 0x1000)])  # exactly half a TF32 ulp above 1
        below = torch.tensor([_f32(sign | one | 0x0FFF)])
        hi_up, hi_below = fa.tf32_split(half_up)[0], fa.tf32_split(below)[0]
        assert int(hi_up.view(torch.int32)[0]) & 0x7FFFFFFF == one | 0x2000
        assert int(hi_below.view(torch.int32)[0]) & 0x7FFFFFFF == one


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_prologue_splits_and_ropes_k(d, rope):
    """Planes 0 and 1 are roped k split: TF32 values whose sum is within
    2^-22 of roped k, zeros at or beyond n_valid (NaN there stays out)."""
    q, k, v, cos, sin = _case(3, 72, d, 61, rope, seed=92)
    planes = fa.tf32_prologue_reference(k, v, 61, cos, sin)
    assert planes.shape == (4, 1, 3, 64, d)
    assert bool(torch.isfinite(planes).all())
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    want = _roped(k[:, :, :61], cos[:61], sin[:61]) if rope else k[:, :, :61]
    got = planes[0, :, :, :61].double() + planes[1, :, :, :61].double()
    assert bool(((got - want.double()).abs() <= 2.0 ** -22 * want.double().abs()).all())
    assert not planes[:2, :, :, 61:].any()


def test_prologue_transposes_v_in_the_key_order():
    """Planes 2 and 3 are V^T (d, n_keys) with the keys of each group of 8 in
    TF32_KEY_ORDER: position 8 g + p holds key 8 g + order[p]; their sum is v
    within 2^-22, and positions of keys at or beyond n_valid are zeros."""
    B, H, N, d, nv = 1, 2, 72, 64, 61
    _, k, v, _, _ = _case(H, N, d, nv, False, seed=93)
    planes = fa.tf32_prologue_reference(k, v, nv)
    n_keys = planes.shape[3]
    vt = planes[2].reshape(B, H, d, n_keys).double() + planes[3].reshape(B, H, d, n_keys).double()
    for p in range(n_keys):
        key = 8 * (p // 8) + fa.TF32_KEY_ORDER[p % 8]
        if key < nv:
            want = v[:, :, key].double()
            assert bool(((vt[..., p] - want).abs() <= 2.0 ** -22 * want.abs()).all()), p
        else:
            assert not vt[..., p].any(), p


def test_key_order_makes_the_accumulator_the_a_fragment():
    """p.V at the level of one warp's registers: thread (g, t) holds, of q.k^T's
    m64nNk8 accumulator for an 8-key group, rows g and g + 8 at keys 2t and
    2t + 1 (elements e = 0..3: row g + 8 (e // 2), key 2 t + (e % 2)). The
    body passes element e as A register e // 2 + 2 (e % 2) of the TF32 A
    fragment, whose register i is row g + 8 (i % 2) at k-index t + 4 (i // 2),
    and wgmma multiplies it by V^T's position k-index of the group. With the
    keys in TF32_KEY_ORDER that product is P V, exactly (integer values)."""
    rng = np.random.default_rng(94)
    P = torch.from_numpy(rng.integers(-8, 9, (16, 8))).double()  # one warp's rows, 8 keys
    V = torch.from_numpy(rng.integers(-8, 9, (8, 5))).double()
    vt = V.T[:, list(fa.TF32_KEY_ORDER)]  # V^T's columns in the body's order
    A = torch.zeros(16, 8, dtype=torch.float64)  # the A operand the fragments form
    for g in range(8):
        for t in range(4):
            for e in range(4):
                value = P[g + 8 * (e // 2), 2 * t + e % 2]  # accumulator element e
                reg = e // 2 + 2 * (e % 2)  # the A register it becomes
                A[g + 8 * (reg % 2), t + 4 * (reg // 2)] = value
    assert torch.equal(A @ vt.T, P @ V)


@pytest.mark.parametrize(
    "kernel,d",
    [("attention_fat", 64), ("attention_packed", 64), ("attention_headmajor", 64),
     ("attention_headmajor", 128)],
)
def test_fp32_at_64_and_128_routes_to_the_tf32_body(kernel, d):
    assert fa.attention_body(kernel, torch.float32, d) == "sm90_f32"
    assert fa.attention_body(kernel, torch.bfloat16, d) == "sm90"


# Every fp32 width's body in K3: the fp32 Hopper body up to 128 and its wide
# form to 256 at every multiple of 4; off the multiples of 4 the route pads
# first, to a built width; the slices body above 256.
FP32_BODIES = {d: "sm90_f32" if d <= 128 else "sm90_f32_wide" for d in range(4, 257, 4)}


@pytest.mark.parametrize("d", [8, 40, 56, 72, 96, 104, 120, 192, 256, 4, 12, 100, 124, 132, 136,
                               200, 248])
def test_other_fp32_widths_stay_on_the_common_body(d):
    """Each fp32 width's body (the name predates the fp32 Hopper bodies'
    other widths, when all of these stayed on the common body, which now
    runs no fp32): FP32_BODIES, reported without launching, and the slices
    body 256 above."""
    assert fa.attention_body("attention_headmajor", torch.float32, d) == FP32_BODIES[d]
    assert fa.headmajor_in_place(torch.float32, d)
    assert fa.attention_body("attention_headmajor", torch.float32, d + 256) == "sm90_f32_slices"


def test_scratch_keys_round_up_to_the_key_tile():
    assert [fa.tf32_scratch_keys(n) for n in (1, 32, 33, 261, 1205)] == [32, 32, 64, 288, 1216]


def test_cpu_prologue_is_its_plain_version_and_counts_no_launch():
    _, k, v, cos, sin = _case(2, 40, 64, 33, True, seed=95)
    before = fa.launches_tf32_prologue
    assert torch.equal(fa.tf32_prologue(k, v, 33, cos, sin),
                       fa.tf32_prologue_reference(k, v, 33, cos, sin))
    assert fa.launches_tf32_prologue == before


def test_prologue_rejects_what_the_kernel_does_not_take():
    """The prologue takes fp32 heads of a multiple of 4 up to 256 (96 since
    the fp32 bodies read other widths through maps at d) and, since the
    slices body, any width above 256 (260 at 320): not 98, not 254, not
    bf16."""
    assert fa.tf32_prologue(torch.zeros(1, 2, 8, 260), torch.zeros(1, 2, 8, 260)).shape[-1] == 320
    for d in (98, 254):
        with pytest.raises(ValueError, match="multiple of 4 up to 256"):
            fa.tf32_prologue(torch.zeros(1, 2, 8, d), torch.zeros(1, 2, 8, d))
    with pytest.raises(ValueError, match="multiple of 4 up to 256"):
        fa.tf32_prologue(*(torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16) for _ in range(2)))
    assert fa.tf32_prologue(torch.zeros(1, 2, 8, 96), torch.zeros(1, 2, 8, 96)).shape[-1] == 128


@pytest.mark.parametrize("prologues", [0, 1])
def test_prologue_count_is_what_the_entry_reported(prologues, monkeypatch):
    """A launch through the fp32 body counts its prologue only as the C
    entry reports queuing it, not because the body code says sm90_f32: an
    entry that ran the body without its prologue leaves the count where it
    was, so chip_smoke's check of the count can fail."""
    monkeypatch.setattr(fa, "launches_sm90_f32", 0)
    monkeypatch.setattr(fa, "launches_tf32_prologue", 0)
    monkeypatch.setattr(fa, "launches_sm90_f32_by_kernel", {})
    monkeypatch.setattr(fa, "launches", 0)
    fa._count_launch("attention_fat", 64, "sm90_f32", prologues)
    assert (fa.launches, fa.launches_sm90_f32, fa.launches_tf32_prologue) == (1, 1, prologues)


def test_ptxas_comparison_keeps_dropped_kernels_apart_from_changed_ones(monkeypatch):
    """chip_ab's --ptxas: a kernel the change no longer builds is listed
    under only_in_parent and is not read as changed; one whose registers
    moved makes all_same false."""
    import chip_ab

    def log(*kernels):
        return "".join(f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
                       f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                       f"ptxas info    : Used {regs} registers, used 1 barriers\n"
                       for name, regs in kernels)

    parent = {"attention_fat": log(("_Z4keepv", 90), ("_Z4gonev", 40))}
    for regs, same in ((90, True), (96, False)):
        change = {"attention_fat": log(("_Z4keepv", regs), ("_Z3newv", 100))}
        monkeypatch.setattr(chip_ab, "build_logs",
                            lambda root, change=change: parent if root == "p" else change)
        got = chip_ab.compare_ptxas("p", "c")
        assert got["only_in_parent"] == {"attention_fat": ["_Z4gonev"]}
        assert list(got["only_in_change"]["attention_fat"]) == ["_Z3newv"]
        assert list(got["kernels"]["attention_fat"]) == ["_Z4keepv"]
        assert got["all_same"] is same


@pytest.mark.parametrize("mangled,label", [
    ("_ZN14cbas_attention4tf3214attention_tf32ILi64ELi4EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "iiiifNS_4sm9010MapAddressE", "tf32<64, 4>"),
    ("_ZN14cbas_attention4tf3214attention_tf32ILi128ELi5EEEv14CUtensorMap_stS2_S2_S2_PKfS4_"
     "iiiifNS_4sm9010MapAddressE", "tf32<128, 5>"),
    ("_ZN14cbas_attention4tf328split_kvILi128EEEvPKfS3_PfS3_S3_iiiNS_6LayoutEx", "split_kv<128>"),
])
def test_chip_smoke_names_the_tf32_kernels(mangled, label):
    """chip_smoke's ptxas report names the body by (head dim, map rank)
    and its prologue by head dim, and a case at d 64 or 128 in fp32
    finds both in the build log."""
    import chip_smoke

    assert chip_smoke.kernel_label(mangled) == label
    d = int(label.split("<")[1].split(",")[0].rstrip(">"))
    log = {chip_smoke.kernel_label(mangled): "112 regs, 0/0 spill",
           f"split_kv<{d}>": "40 regs, 0/0 spill"}
    old = chip_smoke.PTXAS.get("attention_headmajor")
    chip_smoke.PTXAS["attention_headmajor"] = log
    try:
        report = chip_smoke.kernel_ptxas(fa, "attention_headmajor", torch.float32, d)
    finally:
        chip_smoke.PTXAS.pop("attention_headmajor")
        if old is not None:
            chip_smoke.PTXAS["attention_headmajor"] = old
    assert f"split_kv<{d}>: 40 regs" in report
    assert ("tf32<" in report) == label.startswith("tf32")


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (1216, 1205)])
@pytest.mark.parametrize("layout,H,d", [("fat", 12, 64), ("packed", 12, 64),
                                        ("headmajor", 3, 64), ("headmajor", 8, 128)])
def test_tf32_body_matches_plain_on_card(layout, H, d, N, n_valid, rope, cuda_device):
    """The fp32 Hopper body against the plain version within 2e-5 abs + rel
    (chip_smoke's KERNEL_FP32_TOL), NaN in the dead K/V rows; each call one
    launch through it and one of its prologue, whose output matches its
    plain version bit for bit."""
    q, k, v, cos, sin = _case(H, N, d, n_valid, rope, seed=96)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    if rope:
        cos, sin = cos.to(cuda_device), sin.to(cuda_device)
    to_layout = {"fat": lambda t: t.transpose(1, 2).reshape(1, N, H * d),
                 "packed": lambda t: t.reshape(1, H // 2, 2, N, d).transpose(2, 3)
                 .reshape(1, H // 2, N, 2 * d),
                 "headmajor": lambda t: t}[layout]
    entry, plain = {"fat": (fa.fused_attention_fat, fa.attention_fat_reference),
                    "packed": (fa.fused_attention_packed, fa.attention_packed_reference),
                    "headmajor": (fa.fused_attention, fa.attention_headmajor_reference)}[layout]
    ql, kl, vl = (to_layout(t).contiguous() for t in (q, k, v))
    before = fa.launches_sm90_f32, fa.launches_tf32_prologue
    got = entry(ql, kl, vl, d ** -0.5, n_valid, cos, sin)
    assert (fa.launches_sm90_f32, fa.launches_tf32_prologue) == (before[0] + 1, before[1] + 1)
    want = plain(ql, kl, vl, d ** -0.5, n_valid, cos, sin)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= TOL * (1 + want.abs())).all()), float((got - want).abs().max())
    assert torch.equal(fa.tf32_prologue(k, v, n_valid, cos, sin),
                       fa.tf32_prologue_reference(k, v, n_valid, cos, sin))
