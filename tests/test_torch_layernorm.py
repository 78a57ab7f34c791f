"""cbas_tpu_torch.ops.layernorm against the JAX package's LayerNorm.

The plain versions (what the wrappers run on a CPU tensor) are held to
``cbas_tpu.models.vit._ln``, to ``_block``'s residual expression
(``x + h * lambda.astype(x.dtype)``, then ``_ln``) and to the TPU kernel they
port, ``benchmarks/attn_probes/probe25_ln_256.py``'s ``make_pallas_ln``, run
in Pallas interpret mode. The probe builds and times an encoder when it is
imported, so its ``make_pallas_ln`` is taken out of the source with ``ast``.
Inputs come from a numpy seed and include the outlier rows of
``tools/validate_kernels.py``.

Tolerances:

- the residual stream: bit for bit (both round ``h * lambda``, then the
  sum, to x's dtype);
- y: both compute the statistics in fp32 in different summation orders,
  each sum rounded at most about 64 times at these widths, so the fp32 y
  may differ by 128 fp32 ulps (2^-17) relative to the terms it is built
  from, |y - b| (through rstd) and |w| rstd mean|x| (through the mean),
  times kappa = E[x^2] / var for the single-pass variance, whose
  cancellation multiplies the sums' error (1 for two-pass); plus one ulp
  of the output dtype for the final rounding (``chip_smoke.ln_tolerance``,
  the bound ``chip_smoke.py`` holds the kernel to on the card).

The ViT forward on the CPU is held bit for bit to the eager composition it
replaced (each residual add, then ``_ln``), and the fused op is counted:
2L + 1 calls a cls-only forward of L blocks.

The ``cuda`` tests hold the CUDA kernel against its plain version and skip
without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_layernorm.py
"""

import ast
import functools
import os
import re
import types

import numpy as np
import pytest
import torch

import chip_smoke
from cbas_tpu_torch.models import vit as tvit
from cbas_tpu_torch.ops import layernorm as ln

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "benchmarks", "attn_probes", "probe25_ln_256.py")
WIDTHS = (64, 100, 128, 384, 768)
EPS = chip_smoke.LN_EPS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def _rows(D, seed, n=32):
    """``n`` of ``chip_smoke.outlier_rows`` of width D: a quarter each of
    unit noise; unit noise with 4 dims at +-1000; +30 and -100 offsets with
    unit noise."""
    return chip_smoke.outlier_rows(np.random.default_rng(seed), n, D)


def _params(D, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, D).astype(np.float32),        # lambda
            rng.uniform(0.5, 1.5, D).astype(np.float32),        # weight
            (0.1 * rng.standard_normal(D)).astype(np.float32))  # bias


def assert_y_close(got, want, x, w, b, two_pass, dtype):
    """``got`` within the module's y tolerance of ``want``, the LayerNorm of
    the rows ``x`` (all float64 numpy): ``chip_smoke.ln_tolerance``."""
    got, want, x, w, b = (torch.from_numpy(np.asarray(a, np.float64)) for a in (got, want, x, w, b))
    tol, _ = chip_smoke.ln_tolerance(torch, x, want, w, b, two_pass,
                                     8 if dtype == torch.bfloat16 else 24)
    err = (got - want).abs()
    assert (err <= tol).all(), f"max err {err.max()}, worst err/tol {(err / tol).max()}"


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float64)


def _jax_ln(x, w, b, dtype):
    """``cbas_tpu.models.vit._ln`` on numpy inputs, x in ``dtype``."""
    import jax.numpy as jnp

    from cbas_tpu.models import vit as jvit

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    got = jvit._ln({"n.weight": jnp.asarray(w), "n.bias": jnp.asarray(b)}, "n",
                   jnp.asarray(x).astype(jdt), EPS)
    return np.asarray(got.astype(jnp.float32), np.float64)


@pytest.mark.parametrize("two_pass_env", ["", "1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", WIDTHS)
def test_layernorm_reference_matches_jax_ln(D, dtype, two_pass_env, monkeypatch):
    monkeypatch.setenv("CBAS_LN_TWO_PASS", two_pass_env)
    x = _rows(D, seed=D)
    _, w, b = _params(D, seed=D + 1)
    xt = torch.from_numpy(x).to(dtype)
    got = ln.layernorm_reference(xt, torch.from_numpy(w), torch.from_numpy(b), EPS)
    assert got.dtype == dtype and got.shape == xt.shape
    two_pass = ln.use_two_pass(dtype)
    assert two_pass == (dtype == torch.float32 or bool(two_pass_env))
    assert_y_close(_np(got), _jax_ln(x, w, b, dtype), _np(xt), w, b, two_pass, dtype)
    # the wrapper on a CPU tensor is its plain version, bit for bit
    assert torch.equal(ln.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b), EPS), got)
    # and the model's _ln goes through the wrapper
    params = {"n.weight": torch.from_numpy(w), "n.bias": torch.from_numpy(b)}
    assert torch.equal(tvit._ln(params, "n", xt, EPS), got)


@pytest.mark.parametrize("two_pass_env", ["", "1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", WIDTHS)
def test_add_layernorm_reference_matches_jax_block_residual(D, dtype, two_pass_env, monkeypatch):
    """The residual of ``cbas_tpu/models/vit.py::_block`` bit for bit, then
    its ``_ln`` within the y tolerance."""
    import jax.numpy as jnp

    monkeypatch.setenv("CBAS_LN_TWO_PASS", two_pass_env)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _rows(D, seed=D + 2)
    h = np.random.default_rng(D + 3).standard_normal(x.shape).astype(np.float32)
    lam, w, b = _params(D, seed=D + 4)
    xt, ht = (torch.from_numpy(a).to(dtype) for a in (x, h))
    x_new, y = ln.add_layernorm_reference(xt, ht, torch.from_numpy(lam), torch.from_numpy(w),
                                          torch.from_numpy(b), EPS)
    jx = jnp.asarray(x).astype(jdt)
    j_new = jx + jnp.asarray(h).astype(jdt) * jnp.asarray(lam).astype(jx.dtype)
    assert x_new.dtype == dtype
    np.testing.assert_array_equal(_np(x_new), np.asarray(j_new.astype(jnp.float32), np.float64))
    assert_y_close(_np(y), _jax_ln(np.asarray(j_new.astype(jnp.float32)), w, b, dtype),
                   _np(x_new), w, b, ln.use_two_pass(dtype), dtype)
    got = ln.add_layernorm(xt, ht, torch.from_numpy(lam), torch.from_numpy(w),
                           torch.from_numpy(b), EPS)
    assert torch.equal(got[0], x_new) and torch.equal(got[1], y)


def _probe_ln():
    """``make_pallas_ln()`` of the probe's source, its ``pallas_call`` in
    interpret mode (the probe itself builds an encoder at import)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    with open(PROBE) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_pallas_ln")
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    namespace = {"functools": functools, "jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBE, "exec"), namespace)
    return namespace["make_pallas_ln"]()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", WIDTHS)
def test_two_pass_matches_the_probe_pallas_kernel(D, dtype):
    """The port's two-pass form against the TPU kernel it replaces, on
    (2, 16, D) rows."""
    import jax.numpy as jnp

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _rows(D, seed=D + 5).reshape(2, 16, D)
    _, w, b = _params(D, seed=D + 6)
    want = _probe_ln()({"n.weight": jnp.asarray(w), "n.bias": jnp.asarray(b)}, "n",
                       jnp.asarray(x).astype(jdt), EPS)
    assert want.shape == x.shape and want.dtype == jdt
    xt = torch.from_numpy(x).to(dtype)
    got = ln.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b), EPS, two_pass=True)
    assert_y_close(_np(got), np.asarray(want.astype(jnp.float32), np.float64), _np(xt), w, b,
                   True, dtype)


# ---------------------------------------------------------------------------
# The ViT forward: the residual adds fused into the LayerNorms
# ---------------------------------------------------------------------------

CFGS = {
    "dinov3": dict(variant="dinov3", hidden_size=64, num_layers=3, num_heads=2, patch_size=8,
                   num_register_tokens=4, intermediate_size=128, layer_norm_eps=1e-5),
    "dinov2": dict(variant="dinov2", hidden_size=64, num_layers=3, num_heads=2, patch_size=8,
                   num_register_tokens=4, intermediate_size=128, image_size=32),
}


def _model(variant, dtype):
    """A small model with layer scales and affines away from 1 and 0, in
    the forward's form: one q|k|v projection a block (``fuse_qkv``)."""
    cfg = tvit.ViTConfig(**CFGS[variant])
    rng = np.random.default_rng(50)
    params = tvit.init_vit_params(51, cfg)
    for k in params:
        if k.endswith(("lambda1", "norm1.weight", "norm2.weight", "norm.weight",
                       "layernorm.weight")):
            params[k] = rng.uniform(0.1, 2.0, params[k].shape).astype(np.float32)
        elif k.endswith(("norm1.bias", "norm2.bias", "norm.bias", "layernorm.bias")):
            params[k] = (0.1 * rng.standard_normal(params[k].shape)).astype(np.float32)
    return cfg, tvit.fuse_qkv({k: torch.from_numpy(v).to(dtype) for k, v in params.items()}, cfg)


def _eager_ln(params, name, x, eps):
    return ln.layernorm_reference(x, params[f"{name}.weight"], params[f"{name}.bias"], eps)


def _eager_blocks(params, x, cfg, rope, n, prefix):
    """``n`` blocks as the forward composed them before the fusion: each
    residual add, then ``_ln``."""
    eps = cfg.layer_norm_eps
    for i in range(n):
        p = f"{prefix}.{i}"
        h = _eager_ln(params, f"{p}.norm1", x, eps)
        x = x + tvit._attention(params, p, h, cfg, rope) * params[f"{p}.layer_scale1.lambda1"]
        h = _eager_ln(params, f"{p}.norm2", x, eps)
        x = x + tvit._mlp(params, p, h, cfg) * params[f"{p}.layer_scale2.lambda1"]
    return x


def _eager_forward(params, tokens, cfg, rope, cls_only):
    x = tvit._assemble_embeddings(params, tokens, cfg, None)
    prefix, final = ("encoder.layer", "layernorm") if cfg.variant == "dinov2" else ("layer", "norm")
    full = None if rope is None else tvit._full_rope_tables(rope, cfg.num_prefix_tokens)
    last = cfg.num_layers - 1
    x = _eager_blocks(params, x, cfg, full, last if cls_only else cfg.num_layers, prefix)
    if cls_only:
        p, eps = f"{prefix}.{last}", cfg.layer_norm_eps
        h = tvit._attention_cls(params, p, _eager_ln(params, f"{p}.norm1", x, eps), cfg, full)
        x = x[:, :1] + h * params[f"{p}.layer_scale1.lambda1"]
        h = _eager_ln(params, f"{p}.norm2", x, eps)
        x = x + tvit._mlp(params, p, h, cfg) * params[f"{p}.layer_scale2.lambda1"]
    return _eager_ln(params, final, x, cfg.layer_norm_eps)


def _inputs(cfg, dtype):
    rng = np.random.default_rng(52)
    tokens = torch.from_numpy(rng.standard_normal((2, 16, cfg.hidden_size)).astype(np.float32))
    rope = None
    if cfg.variant == "dinov3":
        rope = tuple(torch.from_numpy(t) for t in tvit.rope_tables(cfg, 4, 4))
    return tokens.to(dtype), rope


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["dinov3", "dinov2"])
def test_forward_is_bit_equal_to_the_eager_composition(variant, dtype, cls_only):
    cfg, params = _model(variant, dtype)
    tokens, rope = _inputs(cfg, dtype)
    got = tvit.vit_forward_from_tokens(params, tokens, cfg, rope=rope, cls_only=cls_only)
    want = _eager_forward(params, tokens, cfg, rope, cls_only)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("variant", ["dinov3", "dinov2"])
def test_cls_attention_map_blocks_are_bit_equal_to_the_eager_composition(variant, monkeypatch):
    """``cls_attention_map``'s last norm1 (handed over by the fused tail of
    the block before it) is the eager composition's, bit for bit."""
    cfg, params = _model(variant, torch.bfloat16)
    pixels = torch.from_numpy(np.random.default_rng(53).uniform(0, 1, (2, 3, 32, 32))
                              .astype(np.float32)).to(torch.bfloat16)
    seen = []
    real = tvit._dense

    def spy(params_, name, x, bias=True):  # the last block's q projection sees its norm1
        if name.endswith(("attention.q_proj", "attention.attention.query")):
            seen.append(x)
        return real(params_, name, x, bias)

    monkeypatch.setattr(tvit, "_dense", spy)
    got_map = tvit.cls_attention_map(params, pixels, cfg)
    monkeypatch.setattr(tvit, "_dense", real)
    prefix = "encoder.layer" if variant == "dinov2" else "layer"
    w = params[f"{'embeddings.patch_embeddings.projection' if variant == 'dinov2' else 'embeddings.patch_embeddings'}.weight"]
    bias_name = ("embeddings.patch_embeddings.projection.bias" if variant == "dinov2"
                 else "embeddings.patch_embeddings.bias")
    tokens = torch.nn.functional.linear(tvit.patchify(pixels, cfg.patch_size),
                                        w.reshape(w.shape[0], -1), params[bias_name])
    pos = rope = None
    if variant == "dinov2":
        pos = torch.from_numpy(tvit.resample_pos_embed(
            params["embeddings.position_embeddings"].float().numpy(), 4, 4)).to(torch.bfloat16)
    else:
        rope = tvit._full_rope_tables(
            tuple(torch.from_numpy(t) for t in tvit.rope_tables(cfg, 4, 4)), cfg.num_prefix_tokens)
    x = _eager_blocks(params, tvit._assemble_embeddings(params, tokens, cfg, pos), cfg, rope,
                      cfg.num_layers - 1, prefix)
    want = _eager_ln(params, f"{prefix}.{cfg.num_layers - 1}.norm1", x, cfg.layer_norm_eps)
    assert got_map.shape == (2, 4, 4) and torch.isfinite(got_map).all()
    assert torch.equal(seen[-1], want)


def _count_calls(monkeypatch):
    counts = {"layernorm": 0, "add_layernorm": 0}
    for name in counts:
        real = getattr(ln, name)

        def counted(*args, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(ln, name, counted)
    return counts


@pytest.mark.parametrize("variant", ["dinov3", "dinov2"])
def test_a_cls_only_forward_makes_2L_plus_1_layernorm_calls(variant, monkeypatch):
    """Block 0's norm1 alone, then two fused sites a block: 2L + 1 calls a
    cls-only forward, 2L - 1 a cls_attention_map, none of them eager."""
    cfg, params = _model(variant, torch.float32)
    tokens, rope = _inputs(cfg, torch.float32)
    counts = _count_calls(monkeypatch)
    tvit.vit_forward_from_tokens(params, tokens, cfg, rope=rope, cls_only=True)
    L = cfg.num_layers
    assert counts == {"layernorm": 1, "add_layernorm": 2 * L}
    counts.update(layernorm=0, add_layernorm=0)
    pixels = torch.zeros((1, 3, 32, 32))
    cfg_map, params_map = _model(variant, torch.float32)
    tvit.cls_attention_map(params_map, pixels, cfg_map)
    assert counts == {"layernorm": 1, "add_layernorm": 2 * L - 2}


def test_encoder_forward_makes_2L_plus_1_layernorm_calls(monkeypatch):
    """Through the user's entry point: FrameEncoder.encode_planes, one
    forward a batch."""
    from cbas_tpu_torch.models.encoder import FrameEncoder

    cfg = tvit.ViTConfig(**CFGS["dinov3"])
    enc = FrameEncoder("x", params=tvit.init_vit_params(54, cfg), cfg=cfg, device="cpu")
    planes = np.random.default_rng(55).integers(0, 256, (3, 32, 32), np.uint8)
    counts = _count_calls(monkeypatch)
    enc.encode_planes(planes, batch=3)
    assert counts["layernorm"] + counts["add_layernorm"] == 2 * cfg.num_layers + 1


# ---------------------------------------------------------------------------
# What surrounds the kernel
# ---------------------------------------------------------------------------

def test_rows_reads_the_cls_rows_in_place_and_copies_what_has_no_row_stride():
    stream = torch.arange(2 * 5 * 8, dtype=torch.float32).reshape(2, 5, 8)
    rows, stride = ln._rows(stream[:, :1])
    assert rows.shape == (2, 8) and stride == 40 and rows.data_ptr() == stream.data_ptr()
    rows, stride = ln._rows(stream)
    assert rows.shape == (10, 8) and stride == 8 and rows.data_ptr() == stream.data_ptr()
    t = stream.transpose(0, 1)  # (5, 2, 8): no single row stride
    rows, stride = ln._rows(t)
    assert stride == 8 and torch.equal(rows, t.reshape(10, 8)) and rows.is_contiguous()
    cols = stream.transpose(1, 2)  # the last dim not contiguous
    rows, stride = ln._rows(cols)
    assert stride == 5 and torch.equal(rows, cols.reshape(-1, 5))


def test_the_port_calls_no_library_layernorm():
    """The ViT's LayerNorm is the hand-written kernel: no F.layer_norm,
    nn.LayerNorm or torch.compile in its path."""
    banned = re.compile(r"layer_norm\(|LayerNorm\(|torch\.compile|cudnn")
    for rel in ("cbas_tpu_torch/ops/layernorm.py", "cbas_tpu_torch/models/vit.py",
                "cbas_tpu_torch/csrc/layernorm.cu"):
        with open(os.path.join(ROOT, rel)) as f:
            assert not banned.search(f.read()), rel


def test_chip_smoke_ln_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.py``'s LayerNorm cases at a cut size, the plain version
    on both sides: every case's checks hold."""
    monkeypatch.setattr(chip_smoke, "LN_MAIN_SHAPES", ((2 * 261, 768), (64, 4096)))
    monkeypatch.setattr(chip_smoke, "BATCH_256", 2)
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    out = chip_smoke.ln_kernel_phase(torch, device="cpu")
    assert len(out["main"]) == 2 and len(out["other"]) == 4
    assert all(c["ok"] and c["launches"] == 0 for c in out["main"] + out["other"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("two_pass", [None, True])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", WIDTHS + (4096, 3001))
def test_kernel_matches_plain_on_card(D, dtype, residual, two_pass, cuda_device):
    """The CUDA kernel against its plain version on the card: the residual
    bit for bit, y within the module's tolerance, one launch a call."""
    x = _rows(D, seed=D + 7, n=64)
    h = np.random.default_rng(D + 8).standard_normal(x.shape).astype(np.float32)
    lam, w, b = _params(D, seed=D + 9)
    xt, ht, lt, wt, bt = (torch.from_numpy(a).to(cuda_device, dtype) for a in (x, h, lam, w, b))
    before = ln.launches
    if residual:
        got = ln.add_layernorm(xt, ht, lt, wt, bt, EPS, two_pass)
        want = ln.add_layernorm_reference(xt, ht, lt, wt, bt, EPS, two_pass)
        assert torch.equal(got[0], want[0])
    else:
        got = (xt, ln.layernorm(xt, wt, bt, EPS, two_pass))
        want = (xt, ln.layernorm_reference(xt, wt, bt, EPS, two_pass))
    torch.cuda.synchronize()
    assert ln.launches - before == 1
    assert_y_close(_np(got[1].cpu()), _np(want[1].cpu()), _np(want[0].cpu()), _np(wt.cpu()),
                   _np(bt.cpu()), ln.use_two_pass(dtype, two_pass), dtype)


@pytest.mark.cuda
def test_kernel_reads_the_cls_rows_in_place_on_card(cuda_device):
    rng = np.random.default_rng(56)
    stream, h = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(cuda_device, torch.bfloat16) for s in ((4, 261, 768), (4, 1, 768)))
    lam, w, b = (torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in _params(768, 57))
    got = ln.add_layernorm(stream[:, :1], h, lam, w, b, EPS)
    want = ln.add_layernorm_reference(stream[:, :1], h, lam, w, b, EPS)
    assert torch.equal(got[0], want[0]) and got[1].shape == (4, 1, 768)
