"""cbas_tpu_torch.ops.memory_floor against the TPU kernel it ports.

The plain version (what the wrapper runs on a CPU tensor) is held bit for
bit to ``dma_kernel`` of ``benchmarks/attn_probes/probe14_dma_floor_256.py``
and ``probe15_marginal_256.py`` (``o = q + 0*k + 0*v``), run through the
probes' own ``pallas_call`` block shapes in Pallas interpret mode; the probes
build and time their kernels when imported, so ``dma_kernel`` is taken out
of the source with ``ast``. "Bit for bit" holds wherever the result is a
number; where it is NaN (an Inf or a NaN in k or v), both are NaN, whatever
NaN bits each framework writes. The inputs hold +-Inf and NaN in k and v
and -0 in q, where a copy of q and the expression differ.

The ``cuda`` tests hold the CUDA kernel against its plain version and skip
without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_memory_floor.py
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu_torch.ops import memory_floor as mf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = {name: os.path.join(ROOT, "benchmarks", "attn_probes", f"{name}.py")
          for name in ("probe14_dma_floor_256", "probe15_marginal_256")}
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, np.int16),
          "float32": (torch.float32, jnp.float32, np.int32)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _probe_dma_kernel(probe):
    """``dma_kernel`` of the probe's source."""
    with open(PROBES[probe]) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "dma_kernel")
    namespace = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBES[probe], "exec"), namespace)
    return namespace["dma_kernel"]


def _probe_call(probe, shape, block, jdt):
    """The probe's kernel over ``shape`` in blocks of ``block`` along the
    first dim (probe14's ``make_dma`` and probe15's ``f_dma`` take 3-D
    blocks (gp, N, 128), ``make_dma_flat2d`` 2-D ones (br, 128)), in
    interpret mode."""
    from jax.experimental import pallas as pl

    rest = shape[1:]
    index = (lambda b, i: (b, 0, 0)) if len(shape) == 3 else (lambda b, i: (b, 0))
    spec = pl.BlockSpec((block, *rest), index)
    return pl.pallas_call(_probe_dma_kernel(probe), out_shape=jax.ShapeDtypeStruct(shape, jdt),
                          grid=(shape[0] // block, 1), in_specs=[spec] * 3, out_specs=spec,
                          interpret=True)


def _assert_same(got, want, ints):
    """The tensor ``got`` bit for bit the JAX array ``want`` where ``want``
    is a number, NaN where it is NaN."""
    nan = np.isnan(np.asarray(want.astype(jnp.float32)))
    assert (torch.isnan(got.float()).numpy() == nan).all()
    got_bits = got.view(torch.int16 if ints is np.int16 else torch.int32).numpy()
    assert (got_bits[~nan] == np.asarray(want).view(ints)[~nan]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("probe,shape,block", [
    ("probe14_dma_floor_256", (8, 17, 128), 4),   # make_dma: (gp, N, 128) blocks
    ("probe14_dma_floor_256", (8 * 17, 128), 34),  # make_dma_flat2d: (br, 128) blocks
    ("probe15_marginal_256", (8, 17, 128), 8),    # f_dma: gp = 8
])
def test_plain_version_is_bit_equal_to_the_probe_kernel(probe, shape, block, dtype):
    """The plain version against the probes' ``dma_kernel``: Inf and NaN in
    k or v make o NaN, and q's -0 stays -0 only where k and v are negative."""
    tdt, jdt, ints = DTYPES[dtype]
    q, k, v = chip_smoke.floor_inputs(torch, shape, dtype, "cpu")
    assert tdt == q.dtype
    got = mf.memory_floor(q, k, v)
    want = _probe_call(probe, shape, block, jdt)(
        *(jnp.asarray(t.float().numpy()).astype(jdt) for t in (q, k, v)))
    _assert_same(got, want, ints)
    flat = got.flatten().float()
    assert int(torch.isnan(flat).sum()) == 6 and int(torch.signbit(flat[16:20]).sum()) == 1


def test_plain_version_is_the_expression_not_a_copy():
    q = torch.tensor([1.0, -0.0, -0.0, 2.0])
    k = torch.tensor([float("inf"), 1.0, -1.0, 3.0])
    v = torch.tensor([1.0, 1.0, -1.0, float("nan")])
    got = mf.memory_floor(q, k, v)
    assert torch.isnan(got[0]) and torch.isnan(got[3])
    assert not torch.signbit(got[1]) and torch.signbit(got[2])


def test_wrapper_checks_and_cpu_tensors_never_count_as_launches():
    q = torch.zeros(4, 8)
    before = mf.launches
    assert torch.equal(mf.memory_floor(q, q, q), q)
    assert mf.launches == before
    with pytest.raises(ValueError, match="does not match"):
        mf.memory_floor(q, torch.zeros(4, 9), q)
    with pytest.raises(ValueError, match="does not match"):
        mf.memory_floor(q, q.double(), q)


def test_chip_smoke_floor_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.py``'s floor phase at a cut size, the plain version on
    both sides: every case's checks hold and nothing is counted."""
    rows = (("probe blocks, cut", (6, 17, 128), "bfloat16"), ("flat, cut", (102, 128), "bfloat16"),
            ("attention row, cut", (2 * 261, 2 * 64), "float32"),
            ("layernorm row, cut", (33, 100), "bfloat16"))
    monkeypatch.setattr(chip_smoke, "floor_rows", lambda: rows)
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    out = chip_smoke.floor_phase(torch, device="cpu")
    assert out["launches"] == 0 and len(out["cases"]) == len(rows)
    assert all(c["ok"] and c["bit_equal_where_not_nan"] and c["minus_zero_in_q_kept"] == 1
               for c in out["cases"])


def test_floor_rows_cover_every_timed_row():
    """The floor phase's rows: the probes' own shapes first (probe14's two,
    probe18's flat blocks), then the bytes of each main attention row in both
    dtypes and of the LayerNorm's main rows."""
    rows = chip_smoke.floor_rows()
    assert rows[:len(chip_smoke.FLOOR_SHAPES)] == chip_smoke.FLOOR_SHAPES
    assert [shape for _, shape, _ in chip_smoke.FLOOR_SHAPES] == [
        (384 * 6, 272, 128), (384 * 6 * 272, 128), (384, 272, 768)]
    shapes = {(shape, dtype) for _, shape, dtype in rows}
    for B, N, H, d in chip_smoke.FUSED_SHAPES + chip_smoke.FUSED_SHAPES_7B:
        assert ((B * N, H * d), "bfloat16") in shapes and ((B * N, H * d), "float32") in shapes
    for r, D in chip_smoke.LN_MAIN_SHAPES:
        assert ((r, D), "bfloat16") in shapes
    assert len(rows) == len(set(rows))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(384 * 6, 272, 128), (1000, 77), (37,), (3, 5, 7)])
def test_kernel_is_bit_equal_to_plain_on_card(shape, dtype, cuda_device):
    """The CUDA kernel against its plain version on the card, bit for bit
    (NaN bits included: both round through the same intrinsics), one launch
    a call, at probe14's shape and at sizes with a tail past the last
    16-byte vector."""
    q, k, v = chip_smoke.floor_inputs(torch, shape, dtype, cuda_device)
    before = mf.launches
    got = mf.memory_floor(q, k, v)
    assert mf.launches == before + 1
    want = mf.memory_floor_reference(q, k, v)
    ints = torch.int16 if dtype == "bfloat16" else torch.int32
    assert got.is_contiguous() and torch.equal(got.view(ints), want.view(ints))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_card(cuda_device):
    q = torch.zeros(16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
        mf.memory_floor(q.t(), q, q)
    flat = torch.zeros(257, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous and 16-byte aligned"):
        mf.memory_floor(flat[1:], flat[1:], flat[1:])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mf.memory_floor(*(torch.zeros(8, device=cuda_device, dtype=torch.float16),) * 3)
