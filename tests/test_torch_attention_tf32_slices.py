"""The fp32 slices body, K3's fp32 heads above 256 ("3xTF32"), against the
JAX package's kernel and an fp64 oracle, on the CPU.

``csrc/attention_sm90_tf32_slices.cuh`` computes K3 in float32 at any d
above 256 with attention_sm90_tf32.cuh's arithmetic: the prologue
(``split_kv_wide``) splits K (roped at d/2) and V^T into planes at d
rounded up to 64; a block owns 64 query rows and one 384-column slice of
O; two warpgroups each form q.k^T over ceil(atoms / 2) of d's 32-column
atoms (:func:`halves`), k-step after k-step, its large and its small
products in accumulators of their own, added in fp32, then one
warpgroup's half added to the other's; p.V by 64-column chunk of O. Every
slice forms the same scores in the same order, and each column of p.V is
its own sum, so ``test_torch_attention_tf32_wide.emulate`` is this
arithmetic too: above 256 it runs at the planes' width and splits q.k^T
at its half, which is :func:`halves`' split. A CUDA kernel has no CPU mode,
so these tests hold that emulation against the JAX kernel in Pallas
interpret mode within 2e-5 (the JAX suite's fp32 bound) and against an
fp64 oracle within ``validate_kernels.CARD_TOL_F32`` (5e-6), then the
prologue's plain version above 256, and the routing. Inputs come from
numpy seeds.

The ``cuda`` test holds the kernel against its plain version at phase 10's
shapes and skips without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_tf32_slices.py
"""

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import flash_attention as fa
from cbas_tpu_torch.tools.validate_kernels import CARD_TOL_F32
# The sibling module by its own name (pytest puts tests/ on the path): a
# "tests" package elsewhere on the path may shadow this directory's.
from test_torch_attention_tf32 import TOL, _case, _jax_kernel, _oracle
from test_torch_attention_tf32_wide import emulate

ATOM = 32  # the body's atom of d: 32 fp32 columns


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


def halves(d):
    """The columns each warpgroup forms q.k^T over: ceil(atoms / 2) 32-column
    atoms each, the first half of them and the second (where atoms is odd,
    warpgroup 1's last atom lies past d: zeros on both sides)."""
    split = ATOM * -(-(-(-d // ATOM)) // 2)
    return slice(0, split), slice(split, 2 * split)


@pytest.mark.parametrize("d,N,n_valid,rope", [
    *((d, N, nv, rope) for d in (320, 384) for N, nv in ((261, None), (272, 261))
      for rope in (False, True)),
    (301, 272, 261, False),  # odd: no tables reach the kernel (the wrapper ropes first)
    (257, 261, None, False),  # one live column in the last atom
])
def test_emulated_slices_body_matches_jax_and_fp64(d, N, n_valid, rope):
    """The emulated body against the JAX kernel (interpret mode) within 2e-5
    and against fp64 within CARD_TOL_F32; NaN in the dead rows stays out."""
    q, k, v, cos, sin = _case(1, N, d, n_valid, rope, seed=200 + d + N)
    scale = d ** -0.5
    got = emulate(q, k, v, scale, n_valid, cos, sin)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    want = _jax_kernel("headmajor", q, k, v, scale, n_valid, cos, sin)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    err = (got.double() - _oracle(q, k, v, scale, n_valid, cos, sin)).abs().max()
    assert float(err) < CARD_TOL_F32, float(err)


@pytest.mark.parametrize("d", [257, 301, 320, 330, 384, 1040, 1100])
def test_halves_split_the_atoms_as_the_warpgroups_do(d):
    """Each warpgroup takes ceil(atoms / 2) atoms (at 257 five each,
    warpgroup 1's last one, 288-319, past d): the two halves of the planes'
    width, d rounded up to 64, which is the split the wide form's emulation
    takes above 256 too."""
    w = fa.tf32_width(d)
    assert halves(d) == (slice(0, w // 2), slice(w // 2, w))


@pytest.mark.parametrize("d,rope", [(320, True), (384, False), (330, True), (301, False),
                                    (1100, True)])
def test_prologue_above_256(d, rope):
    """The prologue's planes above 256 at d rounded up to 64: K roped at
    d/2 (330: an odd half, one column a thread on the card), split, then zero
    columns; V^T's rows from d on zero; the first d columns (rows) are the
    planes at d, bit for bit; K's keys past n_valid zero; the CPU entry gives
    the same."""
    _, k, v, cos, sin = _case(1, 70, d, 61, rope, seed=201 + d)
    width = fa.tf32_width(d)
    assert width == -(-d // 64) * 64
    got = fa.tf32_prologue_reference(k, v, 61, cos, sin, width)
    at_d = fa.tf32_prologue_reference(k, v, 61, cos, sin)
    n_keys = got.shape[3]
    assert got.shape == (4, 1, 1, n_keys, width) and n_keys == 64
    assert torch.equal(got[:2, ..., :d], at_d[:2])
    assert not got[:2, ..., d:].any() and not got[:2, :, :, 61:].any()
    vt = got[2:].reshape(2, 1, 1, width, n_keys)
    assert torch.equal(vt[:, :, :, :d], at_d[2:].reshape(2, 1, 1, d, n_keys))
    assert not vt[:, :, :, d:].any()
    assert torch.equal(fa.tf32_prologue(k, v, 61, cos, sin), got)


def test_prologue_refuses_tables_at_an_odd_head_dim():
    """RoPE pairs i with i + d // 2 and back only at an even d: the card's
    prologue takes no tables there, and neither does the entry."""
    _, k, v, _, _ = _case(1, 40, 301, None, False, seed=202)
    cos = torch.ones(40, 301)
    with pytest.raises(ValueError, match="even head dim"):
        fa.tf32_prologue(k, v, None, cos, cos)


@pytest.mark.parametrize("d", [257, 301, 320, 384, 1040])
def test_fp32_above_256_routes_to_the_slices_body(d):
    """Every fp32 head above 256 runs the slices body (C code 5) in place, its
    launches counted at d; bf16 at the same widths stays on the wide body."""
    assert fa.attention_body("attention_headmajor", torch.float32, d) == "sm90_f32_slices"
    assert fa.attention_body("attention_headmajor", torch.bfloat16, d) == "wide"
    assert fa._BODIES[5] == "sm90_f32_slices" and "sm90_f32_slices" in fa.TF32_BODIES
    assert fa.headmajor_in_place(torch.float32, d)
    assert fa.headmajor_in_place(torch.float32, d, True) == (d % 2 == 0)
    assert fa.headmajor_width(torch.float32, d) == d
    assert fa.tf32_width(d) % 64 == 0 and 0 <= fa.tf32_width(d) - d < 64


def test_slices_launch_counts_under_its_own_counter(monkeypatch):
    for name in ("launches_sm90_f32_slices", "launches_sm90_f32_wide", "launches_wide",
                 "launches_tf32_prologue"):
        monkeypatch.setattr(fa, name, 0)
    monkeypatch.setattr(fa, "launches_headmajor_by_dim", {})
    fa._count_launch("attention_headmajor", 320, "sm90_f32_slices", 1)
    assert (fa.launches_sm90_f32_slices, fa.launches_sm90_f32_wide, fa.launches_wide,
            fa.launches_tf32_prologue) == (1, 0, 0, 1)
    assert fa.launches_headmajor_by_dim == {320: 1}



@pytest.mark.parametrize("mangled,label", [
    ("_ZN14cbas_attention11tf32_slices21attention_tf32_slicesILb1EEEv14CUtensorMap_stS2_PKfPfS4_S4_"
     "iiiiiiiNS_6LayoutES6_fi", "tf32_slices<resident Q>"),
    ("_ZN14cbas_attention11tf32_slices21attention_tf32_slicesILb0EEEv14CUtensorMap_stS2_PKfPfS4_S4_"
     "iiiiiiiNS_6LayoutES6_fi", "tf32_slices<streamed Q>"),
    ("_ZN14cbas_attention11tf32_slices13split_kv_wideILi4EEEvPKfS3_PfS3_S3_iiiiiNS_6LayoutEx",
     "split_kv_wide<4>"),
])
def test_chip_smoke_names_the_slices_kernels(mangled, label):
    """chip_smoke's ptxas report names the slices body by Q's mode and its
    prologue by the columns a thread takes, and an fp32 case above 256 finds
    the body it runs (Q resident up to 576, streamed above) with the
    prologue in the build log."""
    import chip_smoke

    assert chip_smoke.kernel_label(mangled) == label
    log = {"tf32_slices<resident Q>": "253 regs, 0/0 spill",
           "tf32_slices<streamed Q>": "250 regs, 0/0 spill", "split_kv_wide<4>": "44 regs, 0/0 spill"}
    old = chip_smoke.PTXAS.get("attention_headmajor")
    chip_smoke.PTXAS["attention_headmajor"] = log
    try:
        resident = chip_smoke.kernel_ptxas(fa, "attention_headmajor", torch.float32, 384)
        streamed = chip_smoke.kernel_ptxas(fa, "attention_headmajor", torch.float32, 1040)
    finally:
        chip_smoke.PTXAS.pop("attention_headmajor")
        if old is not None:
            chip_smoke.PTXAS["attention_headmajor"] = old
    assert resident == "tf32_slices<resident Q>: 253 regs, 0/0 spill; split_kv_wide<4>: 44 regs, 0/0 spill"
    assert streamed.startswith("tf32_slices<streamed Q>: 250 regs")

# --- on the card --------------------------------------------------------------

CARD_CASES = ((8, 16, 261, 320, None), (4, 8, 1205, 384, None), (2, 4, 272, 301, 261),
              (2, 4, 272, 320, 261), (1, 3, 329, 1100, 300), (1, 2, 140, 330, 130))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("B,H,N,d,n_valid", CARD_CASES)
def test_slices_body_matches_plain_on_card(B, H, N, d, n_valid, rope, view, cuda_device):
    """K3 in fp32 above 256 at phase 10's shapes (and 320 with dead keys,
    1100 with Q streamed, 330 with an odd half), against the plain version
    within 2e-5 abs + rel (chip_smoke's KERNEL_FP32_TOL), NaN in the dead
    K/V rows, on contiguous tensors and on head-major views of flat ones;
    each call one launch of the slices body and one of its prologue (whose
    output matches its plain version bit for bit). 301 with RoPE is roped by
    the wrapper first."""
    rng = np.random.default_rng(203 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, d)).astype(np.float32))
               for _ in range(3))
    if n_valid is not None:
        k[:, :, n_valid:] = float("nan")
        v[:, :, n_valid:] = float("nan")
    if view:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    cos = sin = None
    if rope:
        ang = rng.standard_normal((N, -(-d // 2))).astype(np.float32)
        cos, sin = (torch.from_numpy(np.concatenate([f(ang)] * 2, -1)[:, :d].copy()).to(cuda_device)
                    for f in (np.cos, np.sin))

    def counts():
        return (fa.launches_sm90_f32_slices, fa.launches_tf32_prologue,
                fa.launches_headmajor_by_dim.get(d, 0), fa.launches_wide)

    before = counts()
    got = fa.fused_attention(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, n_valid, cos, sin)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= TOL * (1 + want.abs())).all()), float((got - want).abs().max())
    if fa.headmajor_in_place(torch.float32, d, rope):
        assert got.stride() == fa._dense_like(q).stride()
        assert torch.equal(fa.tf32_prologue(k, v, n_valid, cos, sin),
                           fa.tf32_prologue_reference(k, v, n_valid, cos, sin, fa.tf32_width(d)))
