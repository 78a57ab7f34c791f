"""The fp32 Hopper bodies at K3's other fp32 widths ("3xTF32") against the
JAX package's kernel and an fp64 oracle, on the CPU.

``csrc/attention_sm90_tf32_wide.cuh`` computes K3 in float32 at every
multiple of 4 from 132 to 256, built at 192 and 256, and
``csrc/attention_sm90_tf32.cuh`` takes the multiples of 4 up to 128 at 64
or 128; both read a head at another width through tensor maps at d (the
columns beyond load as zeros) with a prologue that writes zeros there, and
rope at d/2. The wide body splits d between two warpgroups: each forms
q.k^T over its half (its large and its small products in accumulators of
their own, added in fp32), and the two halves are added. A CUDA kernel has
no CPU mode, so these tests hold a plain emulation of that arithmetic
(:func:`emulate`, with ``test_torch_attention_tf32.py``'s tensor-core adds)
against the JAX kernel in Pallas interpret mode within 2e-5 (the JAX
suite's fp32 bound) and against an fp64 oracle within
``validate_kernels.CARD_TOL_F32`` (5e-6), then the prologue's plain version
at a width above d, and the routing. Inputs come from numpy seeds.

The ``cuda`` tests hold the kernels against their plain versions and skip
without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_tf32_wide.py
"""

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import flash_attention as fa
from cbas_tpu_torch.tools.validate_kernels import CARD_TOL_F32
# The sibling module by its own name (pytest puts tests/ on the path): a
# "tests" package elsewhere on the path may shadow this directory's.
from test_torch_attention_tf32 import (MASKED, TOL, _case, _jax_kernel, _oracle, _roped,
                                       _small_then_large, _tensor_core)


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is thousands of tiny tensor operations in sequence: one
    intra-op thread runs them as fast as eight and, beside the other test
    workers, without threads that wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def emulate(q, k, v, scale, n_valid=None, cos=None, sin=None):
    """The fp32 Hopper bodies' arithmetic on head-major (B, H, N, d) fp32
    tensors at d's width w = ``fa.tf32_width(d)``: the prologue's planes at
    w (zeros beyond d), Q roped at d/2, scaled, zero-padded to w and split;
    per key tile, q.k^T over each warpgroup's columns (all w of them at 64
    and 128, one half of w each at 192 and 256) as the large and the small
    products in accumulators of their own, added in fp32, then the halves
    added; the mask, the online softmax, P split and p.V in three products
    into the tile's accumulator, added to O alpha by one fp32 FMA. Every
    wgmma sum is :func:`_tensor_core`'s. Returns O's first d columns."""
    B, H, N, d = q.shape
    w = fa.tf32_width(d)
    parts = 1 if w <= 128 else 2
    nv = N if n_valid is None else n_valid
    tile = fa.TF32_KEY_TILE
    planes = fa.tf32_prologue_reference(k, v, nv, cos, sin, w)
    n_keys = planes.shape[3]
    k_hi, k_lo = planes[0], planes[1]
    vt_hi = planes[2].reshape(B, H, w, n_keys)
    vt_lo = planes[3].reshape(B, H, w, n_keys)
    qh = q.float()
    if cos is not None:
        qh = _roped(qh, cos, sin)
    q_hi, q_lo = fa.tf32_split(torch.nn.functional.pad(qh * scale, (0, w - d)))
    pos = torch.tensor([8 * (i // 8) + fa.TF32_KEY_ORDER.index(i % 8) for i in range(tile)])
    o = torch.zeros(B, H, N, w)
    m = torch.full((B, H, N, 1), -torch.inf)
    l = torch.zeros(B, H, N, 1)
    for k0 in range(0, n_keys, tile):
        ks = slice(k0, k0 + tile)
        s = None
        for part in range(parts):
            cols = slice(part * w // parts, (part + 1) * w // parts)
            small, large = _small_then_large(q_hi[..., cols], q_lo[..., cols],
                                             k_hi[:, :, ks, cols], k_lo[:, :, ks, cols])
            partial = _tensor_core(None, large) + _tensor_core(None, small)
            s = partial if s is None else s + partial
        live = torch.arange(k0, k0 + tile) < nv
        s = torch.where(live, s, MASKED)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mx
        p_hi, p_lo = fa.tf32_split(p)
        v_hi = vt_hi[..., ks][..., pos]
        v_lo = vt_lo[..., ks][..., pos]
        small, large = _small_then_large(p_hi, p_lo, v_hi, v_lo)
        pv = _tensor_core(None, small + large)
        o = (o.double() * alpha.double() + pv.double()).float()  # one fp32 FMA
    return (o / l)[..., :d]


WIDE = (136, 192, 200, 256)
NARROW = (100, 120, 20)  # 20: d/2 off the 4-column chunks, 32-column atoms wholly beyond d


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261)])
@pytest.mark.parametrize("d", WIDE + NARROW)
def test_emulated_bodies_match_jax_and_fp64(d, N, n_valid, rope):
    """The emulated body at each width against the JAX kernel (interpret
    mode) within 2e-5 and against fp64 within CARD_TOL_F32; NaN in the dead
    rows stays out."""
    q, k, v, cos, sin = _case(2, N, d, n_valid, rope, seed=170 + d + N)
    scale = d ** -0.5
    got = emulate(q, k, v, scale, n_valid, cos, sin)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    want = _jax_kernel("headmajor", q, k, v, scale, n_valid, cos, sin)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    err = (got.double() - _oracle(q, k, v, scale, n_valid, cos, sin)).abs().max()
    assert float(err) < CARD_TOL_F32, float(err)


def test_emulated_wide_body_at_480p_tokens_within_card_tolerance():
    """At 640x480's 1205 tokens (1000 live, NaN beyond) and d 256, with RoPE:
    within CARD_TOL_F32 of fp64 (the halves' extra fp32 add keeps it
    there)."""
    q, k, v, cos, sin = _case(1, 1205, 256, 1000, True, seed=171)
    got = emulate(q, k, v, 256 ** -0.5, 1000, cos, sin)
    err = (got.double() - _oracle(q, k, v, 256 ** -0.5, 1000, cos, sin)).abs().max()
    assert float(err) < CARD_TOL_F32, float(err)


@pytest.mark.parametrize("d", [64, 128])
def test_emulation_at_the_built_widths_is_the_narrow_bodys(d):
    """At 64 and 128 the emulation is test_torch_attention_tf32's, bit for
    bit: one warpgroup, no pad."""
    from test_torch_attention_tf32 import emulate as emulate_narrow

    q, k, v, cos, sin = _case(2, 80, d, 70, True, seed=172)
    assert torch.equal(emulate(q, k, v, 0.1, 70, cos, sin), emulate_narrow(q, k, v, 0.1, 70, cos, sin))


@pytest.mark.parametrize("d,width", [(100, 128), (136, 192), (200, 256)])
@pytest.mark.parametrize("rope", [False, True])
def test_prologue_at_a_width_above_d(d, width, rope):
    """The prologue's planes at the body's width: K roped at d/2, split, then
    zero columns up to the width; V^T's rows from d on zero; the first d
    columns (rows) are the planes at d, bit for bit."""
    _, k, v, cos, sin = _case(2, 72, d, 61, rope, seed=173)
    got = fa.tf32_prologue_reference(k, v, 61, cos, sin, width)
    at_d = fa.tf32_prologue_reference(k, v, 61, cos, sin)
    n_keys = got.shape[3]
    assert got.shape == (4, 1, 2, n_keys, width)
    assert torch.equal(got[:2, ..., :d], at_d[:2])
    assert not got[:2, ..., d:].any()
    vt = got[2:].reshape(2, 1, 2, width, n_keys)
    assert torch.equal(vt[:, :, :, :d], at_d[2:].reshape(2, 1, 2, d, n_keys))
    assert not vt[:, :, :, d:].any()
    assert torch.equal(fa.tf32_prologue(k, v, 61, cos, sin), got)


@pytest.mark.parametrize("d,width,body", [
    (4, 64, "sm90_f32"), (8, 64, "sm90_f32"), (12, 64, "sm90_f32"), (16, 64, "sm90_f32"),
    (24, 64, "sm90_f32"), (28, 64, "sm90_f32"), (32, 64, "sm90_f32"), (40, 64, "sm90_f32"),
    (60, 64, "sm90_f32"), (100, 128, "sm90_f32"), (124, 128, "sm90_f32"),
    (132, 192, "sm90_f32_wide"), (136, 192, "sm90_f32_wide"), (192, 192, "sm90_f32_wide"),
    (196, 256, "sm90_f32_wide"), (248, 256, "sm90_f32_wide"), (256, 256, "sm90_f32_wide"),
])
def test_fp32_multiples_of_4_run_in_place_at_their_width(d, width, body):
    """An fp32 head of a multiple of 4 up to 256 runs in place (no pad copy)
    on an fp32 Hopper body at tf32_width(d); its launch counts under that
    width."""
    assert fa.tf32_width(d) == width
    assert fa.attention_body("attention_headmajor", torch.float32, d) == body
    assert fa.attention_body("attention_headmajor", torch.float32, width) == body
    assert fa.headmajor_in_place(torch.float32, d) and fa.headmajor_in_place(torch.float32, d, True)
    assert fa.headmajor_width(torch.float32, d) == width


@pytest.mark.parametrize("d,copied_to,width", [(13, 16, 64), (98, 100, 128), (99, 100, 128),
                                               (130, 132, 192), (254, 256, 256)])
def test_fp32_widths_off_multiples_of_4_pad_then_run_there(d, copied_to, width):
    """Other fp32 widths up to 256 are copied, zero-padded to the next
    multiple of 4, which then runs on an fp32 Hopper body at its width."""
    assert not fa.headmajor_in_place(torch.float32, d)
    assert fa.padded_head_dim(d) == copied_to
    assert fa.headmajor_width(torch.float32, d) == width


def test_wide_launch_counts_under_its_own_counter(monkeypatch):
    monkeypatch.setattr(fa, "launches_sm90_f32_wide", 0)
    monkeypatch.setattr(fa, "launches_sm90_f32", 0)
    monkeypatch.setattr(fa, "launches_tf32_prologue", 0)
    monkeypatch.setattr(fa, "launches_headmajor_by_dim", {})
    fa._count_launch("attention_headmajor", 256, "sm90_f32_wide", 1)
    assert (fa.launches_sm90_f32_wide, fa.launches_sm90_f32, fa.launches_tf32_prologue) == (1, 0, 1)
    assert fa.launches_headmajor_by_dim == {256: 1}


# --- on the card --------------------------------------------------------------

CARD_WIDTHS = (132, 136, 160, 192, 200, 248, 256, 4, 8, 12, 16, 20, 32, 36, 60, 68, 100, 124)


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("N,n_valid", [(261, None), (272, 261), (1216, 1205)])
@pytest.mark.parametrize("d", CARD_WIDTHS)
def test_fp32_bodies_match_plain_on_card(d, N, n_valid, rope, view, cuda_device):
    """K3 in fp32 at widths the fp32 Hopper bodies take in place, against the
    plain version within 2e-5 abs + rel (chip_smoke's KERNEL_FP32_TOL), NaN
    in the dead K/V rows, on contiguous tensors and on head-major views of
    flat ones; each call one launch through the body its width routes to
    and one of its prologue (whose output matches its plain version bit for
    bit), none of the common body."""
    H = 3
    q, k, v, cos, sin = _case(H, N, d, n_valid, rope, seed=174)
    if view:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    if rope:
        cos, sin = cos.to(cuda_device), sin.to(cuda_device)
    body = fa.attention_body("attention_headmajor", torch.float32, d)
    width = fa.tf32_width(d)

    def counts():
        return (fa.launches_sm90_f32, fa.launches_sm90_f32_wide, fa.launches_tf32_prologue,
                fa.launches_headmajor_by_dim.get(width, 0))

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + (body == "sm90_f32"), before[1] + (body == "sm90_f32_wide"),
                        before[2] + 1, before[3] + 1)
    assert got.stride() == fa._dense_like(q).stride()
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= TOL * (1 + want.abs())).all()), float((got - want).abs().max())
    assert torch.equal(fa.tf32_prologue(k, v, n_valid, cos, sin),
                       fa.tf32_prologue_reference(k, v, n_valid, cos, sin, width))
