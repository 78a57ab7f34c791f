"""cbas_tpu_torch.ops.relayout against the TPU kernel it ports.

The plain version (what the wrapper runs on a CPU tensor) is held bit for bit
to ``relayout_kt_kernel`` of ``benchmarks/attn_probes/probe26_layouts_256.py``
(flat (B, N, H*d) to (B*H, d, N)), run through the probe's own
``pallas_call`` block shapes (GB images a block) in Pallas interpret mode,
taken out of the source with ``ast`` (the probe builds and times its kernels
when imported) and run with the globals it reads, at a small size: 4 images of
4 heads of 64, N 72, NaN in the dead rows (a copy keeps their bits).

The ``cuda`` tests hold the kernel bit for bit against its plain version on
the card and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_relayout.py
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu_torch.ops import relayout as rl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "benchmarks", "attn_probes", "probe26_layouts_256.py")
B, N, H, D_HEAD, GB = 4, 72, 4, 64, 2
D = H * D_HEAD


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _x(seed=26):
    """Flat (B, N, D) bf16, standard normal x 0.3, NaN in rows 67 and up."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, N, D), np.float32) * 0.3).to(torch.bfloat16)
    x[:, 67:] = float("nan")
    return x


def _probe_relayout(x):
    """probe26's relayout_kt_kernel on ``x`` in interpret mode, as int16 bits."""
    from jax.experimental import pallas as pl

    with open(PROBE) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "relayout_kt_kernel")
    namespace = {"pl": pl, "GB": GB, "H": H, "d": D_HEAD}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBE, "exec"), namespace)
    call = pl.pallas_call(
        namespace["relayout_kt_kernel"],
        out_shape=jax.ShapeDtypeStruct((B * H, D_HEAD, N), jnp.bfloat16), grid=(B // GB, 1),
        in_specs=[pl.BlockSpec((GB, N, D), lambda b, i: (b, 0, 0))],
        out_specs=pl.BlockSpec((GB * H, D_HEAD, N), lambda b, i: (b, 0, 0)), interpret=True)
    bits = x.view(torch.int16).numpy()
    out = call(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16))
    return np.asarray(jax.lax.bitcast_convert_type(out, jnp.int16))


def test_plain_version_is_the_probe_kernel_bit_for_bit():
    """The plain relayout against probe26's relayout_kt_kernel (interpret
    mode): the same bits, NaN rows included."""
    x = _x()
    got = rl.relayout_kt(x, H)
    assert got.shape == (B * H, D_HEAD, N) and got.is_contiguous()
    assert np.array_equal(got.view(torch.int16).numpy(), _probe_relayout(x))
    assert torch.isnan(got[:, :, 67:]).all() and not torch.isnan(got[:, :, :67]).any()


def test_relayout_is_the_transposed_keys_the_batched_kernel_takes():
    """Head h of image b of the output is that head's keys transposed: the
    k operand ``attention_batched`` takes with ``k_transposed``."""
    x = _x(1)
    got = rl.relayout_kt(x, H).view(B, H, D_HEAD, N)
    heads = x.view(B, N, H, D_HEAD).transpose(1, 2)
    assert torch.equal(got.view(torch.int16), heads.transpose(-1, -2).contiguous().view(torch.int16))


def test_relayout_reads_a_strided_view_in_place():
    """The k column block of one fused (B, N, 3D) projection (row stride 3D)
    is read as it is: the same bits as its contiguous copy."""
    buf = torch.cat([_x(2), _x(3), _x(4)], -1)
    k = buf[..., D:2 * D]
    assert not k.is_contiguous()
    assert torch.equal(rl.relayout_kt(k, H).view(torch.int16),
                       rl.relayout_kt(k.contiguous(), H).view(torch.int16))


@pytest.mark.parametrize("case,match", [
    ("float32", "built for bfloat16"),
    ("4-dim", "expected flat"),
    ("heads not dividing", "expected flat"),
    ("N not a multiple of 8", "multiples of 8"),
    ("misaligned base", "starts at"),
    ("strided columns", "the last dim must have stride 1"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """On the CPU as on the card: the refusals come before the plain version."""
    x, heads = torch.zeros(2, 16, 128, dtype=torch.bfloat16), 2
    if case == "float32":
        x = x.float()
    elif case == "4-dim":
        x = x[None]
    elif case == "heads not dividing":
        heads = 3
    elif case == "N not a multiple of 8":
        x = torch.zeros(2, 12, 128, dtype=torch.bfloat16)
    elif case == "misaligned base":
        x = torch.zeros(2 * 16 * 128 + 8, dtype=torch.bfloat16)[1:1 + 2 * 16 * 128].view(2, 16, 128)
    elif case == "strided columns":
        x = torch.zeros(2, 16, 256, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match=match):
        rl.relayout_kt(x, heads)


def test_launches_count_kernel_launches_only(monkeypatch):
    """A CPU call never counts."""
    monkeypatch.setattr(rl, "launches", 0)
    rl.relayout_kt(_x(), H)
    assert rl.launches == 0


def test_chip_smoke_relayout_case_runs_on_cpu(monkeypatch):
    """chip_smoke's relayout case at a cut size, the plain version on both
    sides: bit for bit, nothing counted."""
    monkeypatch.setattr(chip_smoke, "RELAYOUT_SHAPE", (2, 72, 4, 64, 67))
    out = chip_smoke.relayout_case(torch, rl, device="cpu")
    assert out["ok"] and out["bit_equal"] and out["launches"] == 0
    assert out["shape_out"] == [8, 64, 72]
    assert chip_smoke.RELAYOUT_REPLACES.endswith("probe26_layouts_256.py:154")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(448, 272, 12), (3, 72, 4), (2, 1216, 12), (5, 40, 2)])
def test_relayout_is_bit_for_bit_on_card(shape, cuda_device):
    """The kernel against its plain version on the card: probe26's shape, a
    partial tile of tokens and of columns, NaN rows kept; on a strided view."""
    b, n, h = shape
    gen = torch.Generator(cuda_device).manual_seed(7)
    x = torch.randn(b, n, 3 * h * 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    x[:, n - 3:] = float("nan")
    for t in (x[..., :h * 64].contiguous(), x[..., h * 64:2 * h * 64]):
        before = rl.launches
        got = rl.relayout_kt(t, h)
        torch.cuda.synchronize()
        assert rl.launches == before + 1
        assert torch.equal(got.view(torch.int16), rl.relayout_kt_reference(t, h).view(torch.int16))
