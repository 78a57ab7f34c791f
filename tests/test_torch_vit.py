"""cbas_tpu_torch.models.vit against cbas_tpu.models.vit on the CPU.

Weights come from the JAX package's own init, carried across as numpy;
inputs come from a numpy seed. Forward tolerance: atol 1e-4 in fp32 (two
frameworks, different summation order through a few layers).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cbas_tpu.models import vit as jvit
from cbas_tpu_torch.models import vit as tvit
from cbas_tpu_torch.models.convert import vit_params_from_numpy

DEMO_ENCODER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "demo_project", "demo_encoder",
)

SMALL = {
    "dinov3": dict(
        variant="dinov3", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
        num_register_tokens=4, intermediate_size=256, layer_norm_eps=1e-5,
    ),
    "dinov2": dict(
        variant="dinov2", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
        num_register_tokens=4, intermediate_size=256, image_size=32,
    ),
    "dinov3-gated": dict(
        variant="dinov3", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
        num_register_tokens=0, intermediate_size=256, use_gated_mlp=True, key_bias=True,
    ),
    "dinov2-swiglu": dict(
        variant="dinov2", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
        num_register_tokens=0, intermediate_size=176, image_size=32, use_swiglu_ffn=True,
    ),
}
ATOL = 1e-4


def _params(name):
    jcfg = jvit.ViTConfig(**SMALL[name])
    return jcfg, tvit.ViTConfig(**SMALL[name]), jax.device_get(
        jvit.init_vit_params(jax.random.key(1), jcfg)
    )


def test_presets_equal_jax():
    assert set(tvit.PRESETS) == set(jvit.PRESETS)
    for name, cfg in jvit.PRESETS.items():
        assert dataclasses.asdict(tvit.PRESETS[name]) == dataclasses.asdict(cfg), name


@pytest.mark.parametrize(
    "identifier",
    [DEMO_ENCODER, "dinov3-vitb16", "facebook/dinov3-vits16-pretrain", "my-dinov3-thing",
     "dinov2-with-registers-small", "unknown-model"],
)
def test_config_for_identifier_equals_jax(identifier):
    assert dataclasses.asdict(tvit.config_for_identifier(identifier)) == dataclasses.asdict(
        jvit.config_for_identifier(identifier)
    )


def test_from_hf_equals_jax():
    transformers = pytest.importorskip("transformers")
    for hf in (transformers.DINOv3ViTConfig(), transformers.Dinov2WithRegistersConfig()):
        assert dataclasses.asdict(tvit.ViTConfig.from_hf(hf)) == dataclasses.asdict(
            jvit.ViTConfig.from_hf(hf)
        )


@pytest.mark.parametrize("grid", [(16, 16), (30, 40), (3, 5)])
def test_rope_tables_equal(grid):
    cfg = tvit.PRESETS["dinov3-vitb16"]
    for got, want in zip(tvit.rope_tables(cfg, *grid), jvit.rope_tables(cfg, *grid)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(SMALL))
def test_init_has_jax_names_and_shapes(name):
    jcfg, tcfg, jparams = _params(name)
    ours = tvit.init_vit_params(0, tcfg)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in jparams.items()}
    w = ours["embeddings.cls_token"]
    assert w.dtype == np.float32 and np.abs(w).max() <= 2 * 0.02 / 0.8796 + 1e-6


def test_params_from_numpy_rejects_other_architectures():
    _, tcfg, jparams = _params("dinov3")
    with pytest.raises(ValueError, match="shape"):
        vit_params_from_numpy({"layer.0.norm1.weight": np.ones(64, np.float32)}, tcfg)
    with pytest.raises(ValueError, match="not a parameter"):
        vit_params_from_numpy({"encoder.layer.0.norm1.weight": np.ones(128, np.float32)}, tcfg)


def _forward_both(name, cls_only, seed=0):
    jcfg, tcfg, jparams = _params(name)
    rng = np.random.default_rng(seed)
    grid = (2, 3) if tcfg.variant == "dinov3" else (2, 2)  # dinov2: its native 32x32 table
    tokens = rng.standard_normal((2, grid[0] * grid[1], tcfg.hidden_size)).astype(np.float32)
    rope_np = tvit.rope_tables(tcfg, *grid) if tcfg.variant == "dinov3" else None
    want = jvit.vit_forward_from_tokens(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tokens), jcfg,
        rope=None if rope_np is None else tuple(jnp.asarray(t) for t in rope_np),
        cls_only=cls_only,
    )
    got = tvit.vit_forward_from_tokens(
        vit_params_from_numpy(jparams, tcfg), torch.from_numpy(tokens), tcfg,
        rope=None if rope_np is None else tuple(torch.from_numpy(t) for t in rope_np),
        cls_only=cls_only,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cls_only", [False, True])
@pytest.mark.parametrize("name", list(SMALL))
def test_forward_from_tokens_matches_jax(name, cls_only):
    got, want = _forward_both(name, cls_only)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["dinov3", "dinov2"])
def test_cls_only_row_equals_full_forward_row(name):
    _, tcfg, jparams = _params(name)
    params = vit_params_from_numpy(jparams, tcfg)
    rng = np.random.default_rng(3)
    grid = (2, 2)
    tokens = torch.from_numpy(rng.standard_normal((3, 4, 128)).astype(np.float32))
    rope = tuple(torch.from_numpy(t) for t in tvit.rope_tables(tcfg, *grid))
    rope = rope if tcfg.variant == "dinov3" else None
    full = tvit.vit_forward_from_tokens(params, tokens, tcfg, rope=rope)
    cls = tvit.vit_forward_from_tokens(params, tokens, tcfg, rope=rope, cls_only=True)
    assert cls.shape == (3, 1, 128)
    np.testing.assert_allclose(cls[:, 0].numpy(), full[:, 0].numpy(), atol=1e-5, rtol=0)


def test_vit_forward_pixels_matches_jax():
    """The full pixel path (patchify + conv-as-matmul + RoPE from geometry)."""
    jcfg, tcfg, jparams = _params("dinov3")
    pixels = np.random.default_rng(4).random((2, 3, 32, 48), dtype=np.float32)
    want = jvit.cls_embeddings({k: jnp.asarray(v) for k, v in jparams.items()},
                               jnp.asarray(pixels), jcfg)
    got = tvit.cls_embeddings(vit_params_from_numpy(jparams, tcfg), torch.from_numpy(pixels), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_resample_pos_embed_equals_jax():
    pos = np.random.default_rng(5).standard_normal((1, 1 + 16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tvit.resample_pos_embed(pos, 3, 5), jvit.resample_pos_embed(pos, 3, 5), atol=1e-6
    )


# Configurations for each attention route, as (config, CBAS_ATTN_FAT, the
# entry both packages' _attention call). dinov3 with RoPE throughout.
ROUTES = {
    "hd32": (dict(SMALL["dinov3"], num_heads=4), None, "fused_attention"),
    "hd128-gated": (
        dict(SMALL["dinov3-gated"], hidden_size=256, num_register_tokens=4), None,
        "fused_attention",
    ),
    "hd64-3heads": (dict(SMALL["dinov3"], hidden_size=192, num_heads=3), None, "fused_attention"),
    "hd64-packed": (SMALL["dinov3"], "0", "fused_attention_packed"),
    "hd64x4-packed": (dict(SMALL["dinov3"], hidden_size=256, num_heads=4), "0",
                      "fused_attention_packed"),
    "hd64-flat": (SMALL["dinov3"], None, "fused_attention_fat"),
}


@pytest.fixture
def restore_fused_flag():
    yield
    jvit.set_fused_attention(None)


def _route_forward(name, monkeypatch, fused):
    """Both packages' forward over one route's config, from the same numpy
    weights and tokens; the JAX side with its fused path on (its Pallas
    kernels in interpret mode) or off (its unfused jnp path)."""
    kwargs, fat_env, _ = ROUTES[name]
    if fat_env is None:
        monkeypatch.delenv("CBAS_ATTN_FAT", raising=False)
    else:
        monkeypatch.setenv("CBAS_ATTN_FAT", fat_env)
    jvit.set_fused_attention(fused)
    jcfg, tcfg = jvit.ViTConfig(**kwargs), tvit.ViTConfig(**kwargs)
    jparams = jax.device_get(jvit.init_vit_params(jax.random.key(2), jcfg))
    rng = np.random.default_rng(6)
    grid = (2, 3)
    tokens = rng.standard_normal((2, 6, tcfg.hidden_size)).astype(np.float32)
    rope_np = tvit.rope_tables(tcfg, *grid)
    want = jvit.vit_forward_from_tokens(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tokens), jcfg,
        rope=tuple(jnp.asarray(t) for t in rope_np),
    )
    got = tvit.vit_forward_from_tokens(
        vit_params_from_numpy(jparams, tcfg), torch.from_numpy(tokens), tcfg,
        rope=tuple(torch.from_numpy(t) for t in rope_np),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize(
    "name", ["hd32", "hd128-gated", "hd64-3heads", "hd64-packed", "hd64x4-packed"]
)
def test_forward_matches_jax_on_every_route(name, fused, monkeypatch, restore_fused_flag):
    """Head dims 32 and 128 and an odd head count run through K3, and 64-wide
    pairs (one and two of them) with CBAS_ATTN_FAT=0 through K2, matching
    the JAX forward with its fused kernels (K3 or K2 in interpret mode) and
    without them."""
    got, want = _route_forward(name, monkeypatch, fused)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(ROUTES))
def test_attention_route_matches_jax_rule(name, monkeypatch, restore_fused_flag):
    """The port's _attention calls the same kernel entry as the JAX
    package's, for each head width, head count and CBAS_ATTN_FAT setting."""
    from cbas_tpu.ops import flash_attention as jfa
    from cbas_tpu_torch.ops import flash_attention as tfa

    entries = ("fused_attention_fat", "fused_attention_packed", "fused_attention")
    calls = {"jax": [], "torch": []}
    for who, mod in (("jax", jfa), ("torch", tfa)):
        for entry in entries:
            def spy(*a, _entry=entry, _fn=getattr(mod, entry), _who=who, **kw):
                calls[_who].append(_entry)
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, entry, spy)
    got, want = _route_forward(name, monkeypatch, fused=True)
    expected = ROUTES[name][2]
    layers = SMALL["dinov3"]["num_layers"]
    assert calls["torch"] == calls["jax"] == [expected] * layers
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _spy_fused_projection(monkeypatch, width):
    """Record the output of each ``F.linear`` whose weight has ``width``
    rows (a block's fused q|k|v projection, 3 H hd) and the input of each
    ``_dense`` call (the out-projection's), by name."""
    fused_out, dense_in = [], {}
    real_linear, real_dense = tvit.F.linear, tvit._dense

    def linear(x, weight, bias=None):
        y = real_linear(x, weight, bias)
        if weight.shape[0] == width:
            fused_out.append(y)
        return y

    def dense(params, name, x, bias=True):
        dense_in[name] = x
        return real_dense(params, name, x, bias)

    monkeypatch.setattr(tvit.F, "linear", linear)
    monkeypatch.setattr(tvit, "_dense", dense)
    return fused_out, dense_in


def _storage(t):
    return t.untyped_storage().data_ptr()


def _assert_views_of_fused(operands, fused, heads, hd):
    """q, k and v are non-contiguous views of one fused (B, N, 3 H hd)
    projection output, at its column offsets 0, H hd and 2 H hd."""
    width = heads * hd
    for j, t in enumerate(operands):
        assert not t.is_contiguous()
        assert _storage(t) == _storage(fused)
        assert t.data_ptr() - fused.data_ptr() == j * width * fused.element_size()


def test_packed_route_passes_views_of_the_projections(monkeypatch, restore_fused_flag):
    """Under CBAS_ATTN_FAT=0 the packed route (two head pairs) makes one q|k|v
    projection a block and hands K2 non-contiguous head-pair views of its
    output (the q, k and v column blocks, storage shared), and the
    out-projection reads a view of K2's output: no copy of q, k, v or the
    context. The forward still matches the JAX package's."""
    from cbas_tpu_torch.ops import flash_attention as tfa

    calls = []
    real_packed = tfa.fused_attention_packed

    def packed(q2, k2, v2, *args, **kwargs):
        calls.append(((q2, k2, v2), real_packed(q2, k2, v2, *args, **kwargs)))
        return calls[-1][1]

    kwargs = ROUTES["hd64x4-packed"][0]
    fused_out, dense_in = _spy_fused_projection(monkeypatch, 3 * kwargs["hidden_size"])
    monkeypatch.setattr(tfa, "fused_attention_packed", packed)
    got, want = _route_forward("hd64x4-packed", monkeypatch, fused=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    layers = SMALL["dinov3"]["num_layers"]
    assert len(calls) == len(fused_out) == layers  # one projection GEMM a block
    for i, (operands, ctx) in enumerate(calls):
        _assert_views_of_fused(operands, fused_out[i], kwargs["num_heads"], 64)
        assert _storage(dense_in[f"layer.{i}.attention.o_proj"]) == _storage(ctx)


def test_headmajor_route_passes_views_of_the_projections(monkeypatch, restore_fused_flag):
    """Head dim 32 (the head-major route) makes one q|k|v projection and
    hands K3 non-contiguous head-major views of its output (the q, k and v
    column blocks, storage shared), and the out-projection reads a view of
    K3's output: no copy of q, k, v or the context. One block's attention
    equals the JAX package's _attention (its K3 in interpret mode) at the
    same numpy weights, within ATOL (fp32 on both sides, summation order
    only)."""
    from cbas_tpu_torch.ops import flash_attention as tfa

    kwargs = ROUTES["hd32"][0]
    monkeypatch.delenv("CBAS_ATTN_FAT", raising=False)
    jvit.set_fused_attention(True)
    jcfg, tcfg = jvit.ViTConfig(**kwargs), tvit.ViTConfig(**kwargs)
    assert tcfg.head_dim == 32
    jparams = jax.device_get(jvit.init_vit_params(jax.random.key(3), jcfg))
    grid = (2, 3)
    N = tcfg.num_prefix_tokens + grid[0] * grid[1]
    x = np.random.default_rng(8).standard_normal((2, N, tcfg.hidden_size)).astype(np.float32)
    rope_np = tvit.rope_tables(tcfg, *grid)
    want = jvit._attention({k: jnp.asarray(v) for k, v in jparams.items()}, "layer.0",
                           jnp.asarray(x), jcfg, rope=tuple(jnp.asarray(t) for t in rope_np))

    calls = []
    real_headmajor = tfa.fused_attention

    def headmajor(q, k, v, *args, **kwargs):
        calls.append(((q, k, v), real_headmajor(q, k, v, *args, **kwargs)))
        return calls[-1][1]

    params = vit_params_from_numpy(jparams, tcfg)
    fused_out, dense_in = _spy_fused_projection(monkeypatch, 3 * tcfg.hidden_size)
    monkeypatch.setattr(tfa, "fused_attention", headmajor)
    rope = tvit._full_rope_tables(tuple(torch.from_numpy(t) for t in rope_np),
                                  tcfg.num_prefix_tokens)
    got = tvit._attention(params, "layer.0", torch.from_numpy(x), tcfg, rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    assert len(calls) == len(fused_out) == 1
    (operands, ctx), = calls
    _assert_views_of_fused(operands, fused_out[0], tcfg.num_heads, 32)
    assert _storage(dense_in["layer.0.attention.o_proj"]) == _storage(ctx)


# The port's forward against Hugging Face's modules, random weights from
# small configs (nothing is downloaded): fp32 on both sides, the JAX
# package's own bound against the same modules (tests/test_vit_parity.py).
HF_TOL = dict(rtol=5e-5, atol=5e-5)


def _hf_model(variant, gated=False, image_size=32):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if variant == "dinov2":
        from transformers.models.dinov2_with_registers.modeling_dinov2_with_registers import (
            Dinov2WithRegistersModel,
        )

        hf_cfg = transformers.Dinov2WithRegistersConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2, patch_size=16,
            image_size=image_size, num_register_tokens=4, attn_implementation="eager",
        )
        return Dinov2WithRegistersModel(hf_cfg).eval(), tvit.ViTConfig.from_hf(hf_cfg)
    from transformers.models.dinov3_vit.modeling_dinov3_vit import DINOv3ViTModel

    hf_cfg = transformers.DINOv3ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2, patch_size=16,
        image_size=image_size, num_register_tokens=4, intermediate_size=256,
        use_gated_mlp=gated, attn_implementation="eager",
    )
    return DINOv3ViTModel(hf_cfg).eval(), tvit.ViTConfig.from_hf(hf_cfg)


@pytest.mark.parametrize("variant,gated,shape", [
    ("dinov2", False, (2, 3, 32, 32)),   # the native position table
    ("dinov2", False, (2, 3, 64, 48)),   # resampled to a 4x3 grid
    ("dinov3", False, (2, 3, 32, 32)),
    ("dinov3", True, (2, 3, 48, 64)),    # gated MLP, rectangular input
])
def test_forward_matches_hf(variant, gated, shape):
    from cbas_tpu_torch.models.torch_port import state_dict_to_params

    model, cfg = _hf_model(variant, gated)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        want = model(x).last_hidden_state.numpy()
    params_np = state_dict_to_params(model.state_dict())
    del params_np["embeddings.mask_token"]  # pretraining only; the forward never reads it
    pos = None
    if variant == "dinov2":
        pos = torch.from_numpy(tvit.resample_pos_embed(
            params_np["embeddings.position_embeddings"], shape[2] // 16, shape[3] // 16))
    got = tvit.vit_forward(vit_params_from_numpy(params_np, cfg), x, cfg, pos_embed=pos).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **HF_TOL)
