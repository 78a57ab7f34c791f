"""One q|k|v projection a block: cbas_tpu_torch against the JAX package and
the TPU probe it ports, on the CPU.

``models/vit.py::fuse_qkv`` concatenates each block's q, k and v weights into
one, ``_attention`` makes one ``F.linear`` over it and hands the kernels
views of its (B, N, 3 HD) output (``benchmarks/attn_probes/
probe22_qkvfused_256.py``'s fused projection), and ``_attention_cls`` makes
one k|v ``F.linear``. The kernels (their plain versions here) take the
views and write a dense output in q's dim order.

Tolerances:

- the forward and ``_attention`` against ``cbas_tpu``'s at the same numpy
  weights: ``tests/test_torch_vit.py``'s ATOL (fp32 on both sides, the
  summation order of two frameworks through a few layers);
- the plain K1 on fused views against probe22's Pallas kernel (interpret
  mode, bf16): the probe rounds each RoPE product and sum to bf16 and the
  table to bf16 (``:53-54``), the port rounds roped q and k once from fp32,
  so a roped element differs by at most four bf16 roundings (2^-7) of its
  terms m = |x| |cos| + |x_partner| |sin|, and a score by at most 2^-6 of
  scale * sum m_q m_k over the head ("four bf16 ulps of q.k" at the terms'
  magnitude). A row's output moves by at most exp(2 delta) - 1 of max|v|
  when its scores move by delta; both round p to bf16 before p.V (2^-8 of
  max|v| between them) and round the output (a bf16 ulp each).
"""

import ast
import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cbas_tpu.models import vit as jvit
from cbas_tpu_torch.models import vit as tvit
from cbas_tpu_torch.models.convert import params_to_device, vit_params_from_numpy
from cbas_tpu_torch.ops import flash_attention as fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "benchmarks", "attn_probes", "probe22_qkvfused_256.py")
ATOL = 1e-4  # tests/test_torch_vit.py's

BASE = dict(variant="dinov3", hidden_size=128, num_layers=2, num_heads=2, patch_size=16,
            num_register_tokens=4, intermediate_size=256, layer_norm_eps=1e-5)
# Each route as (config, CBAS_ATTN_FAT, the kernel entry it takes).
ROUTES = {
    "64-wide flat (K1)": (BASE, None, "fused_attention_fat"),
    "64-wide packed (K2)": (dict(BASE, hidden_size=256, num_heads=4), "0",
                            "fused_attention_packed"),
    "head dim 32 (K3)": (dict(BASE, num_heads=4), None, "fused_attention"),
}


@pytest.fixture
def restore_fused_flag():
    yield
    jvit.set_fused_attention(None)


def _route(name, monkeypatch, key=5):
    kwargs, fat_env, entry = ROUTES[name]
    if fat_env is None:
        monkeypatch.delenv("CBAS_ATTN_FAT", raising=False)
    else:
        monkeypatch.setenv("CBAS_ATTN_FAT", fat_env)
    jvit.set_fused_attention(True)
    jcfg, tcfg = jvit.ViTConfig(**kwargs), tvit.ViTConfig(**kwargs)
    return jcfg, tcfg, jax.device_get(jvit.init_vit_params(jax.random.key(key), jcfg)), entry


def _inputs(tcfg, seed=9, grid=(2, 3)):
    N = tcfg.num_prefix_tokens + grid[0] * grid[1]
    x = np.random.default_rng(seed).standard_normal((2, N, tcfg.hidden_size)).astype(np.float32)
    return x, tvit.rope_tables(tcfg, *grid)


def _spy_linear(monkeypatch):
    """Every ``F.linear`` the model issues, as (input, weight, output)."""
    calls = []
    real = tvit.F.linear

    def linear(x, weight, bias=None):
        calls.append((x, weight, real(x, weight, bias)))
        return calls[-1][2]

    monkeypatch.setattr(tvit.F, "linear", linear)
    return calls


# ---------------------------------------------------------------------------
# fuse_qkv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dinov3", "dinov2"])
def test_fuse_qkv_views_share_storage_and_zero_bias(variant):
    """The fused weight is q, k and v stacked; the three names become row
    views of it (one storage, no second copy), and the fused bias holds
    zeros where the config has no bias (dinov3's key_bias)."""
    cfg = tvit.ViTConfig(**dict(BASE, variant=variant, image_size=32))
    raw = tvit.init_vit_params(3, cfg)
    rng = np.random.default_rng(4)
    for k in raw:
        if k.endswith(".bias"):
            raw[k] = rng.standard_normal(raw[k].shape).astype(np.float32)
    params = vit_params_from_numpy(raw, cfg)
    D = cfg.hidden_size
    for i in range(cfg.num_layers):
        prefix = f"encoder.layer.{i}" if variant == "dinov2" else f"layer.{i}"
        names, flags, _, _ = tvit._attn_param_table(cfg, prefix)
        w, b = params[f"{prefix}.attention.qkv.weight"], params[f"{prefix}.attention.qkv.bias"]
        assert w.shape == (3 * D, D) and b.shape == (3 * D,) and w.is_contiguous()
        for j, (name, flag) in enumerate(zip(names, flags)):
            view = params[f"{name}.weight"]
            assert view.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
            assert view.data_ptr() == w.data_ptr() + j * D * D * w.element_size()
            np.testing.assert_array_equal(view.numpy(), raw[f"{name}.weight"])
            rows = b[j * D:(j + 1) * D]
            if flag:
                assert params[f"{name}.bias"].data_ptr() == rows.data_ptr()
                np.testing.assert_array_equal(rows.numpy(), raw[f"{name}.bias"])
            else:
                assert f"{name}.bias" not in params and not rows.any()
    assert variant == "dinov2" or not cfg.key_bias  # the zero block was exercised on dinov3
    again = tvit.fuse_qkv(params, cfg)  # fused already: left as it is
    assert again is params and params[f"{prefix}.attention.qkv.weight"] is w


def test_forward_without_the_fused_weight_raises_naming_fuse_qkv():
    """There is no three-GEMM path: a dict that skipped fuse_qkv raises."""
    cfg = tvit.ViTConfig(**BASE)
    params = params_to_device(tvit.init_vit_params(0, cfg))
    x, rope = _inputs(cfg)
    with pytest.raises(KeyError, match="fuse_qkv"):
        tvit._attention(params, "layer.0", torch.from_numpy(x), cfg, None)
    partial = dict(params)
    del partial["layer.0.attention.k_proj.weight"]
    with pytest.raises(KeyError, match="fuse_qkv needs all of"):
        tvit.fuse_qkv(partial, cfg)


# ---------------------------------------------------------------------------
# The forward against the JAX package, route by route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ROUTES))
def test_attention_makes_one_projection_and_matches_jax(name, monkeypatch, restore_fused_flag):
    """One block's attention issues one projection GEMM, hands the route's
    kernel views of its output (storage shared, column offsets 0, HD, 2HD)
    and equals cbas_tpu's _attention (its kernel in interpret mode)."""
    jcfg, tcfg, jparams, entry = _route(name, monkeypatch)
    x, rope_np = _inputs(tcfg)
    want = jvit._attention({k: jnp.asarray(v) for k, v in jparams.items()}, "layer.0",
                           jnp.asarray(x), jcfg, rope=tuple(jnp.asarray(t) for t in rope_np))
    params = vit_params_from_numpy(jparams, tcfg)
    seen = []
    real_entry = getattr(fa, entry)

    def spy(q, k, v, *args, **kwargs):
        seen.append(((q, k, v), real_entry(q, k, v, *args, **kwargs)))
        return seen[-1][1]

    monkeypatch.setattr(fa, entry, spy)
    linears = _spy_linear(monkeypatch)
    rope = tvit._full_rope_tables(tuple(torch.from_numpy(t) for t in rope_np),
                                  tcfg.num_prefix_tokens)
    got = tvit._attention(params, "layer.0", torch.from_numpy(x), tcfg, rope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    fused_w = params["layer.0.attention.qkv.weight"]
    projections = [y for _, w, y in linears if w is fused_w]
    assert len(projections) == 1 and len(linears) == 2  # the fused projection, the out-projection
    (operands, ctx), = seen
    HD = tcfg.hidden_size
    for j, t in enumerate(operands):
        assert not t.is_contiguous()
        assert t.untyped_storage().data_ptr() == projections[0].untyped_storage().data_ptr()
        assert t.data_ptr() - projections[0].data_ptr() == j * HD * t.element_size()
    assert ctx.stride() == fa._dense_like(operands[0]).stride()


@pytest.mark.parametrize("name", list(ROUTES))
def test_cls_only_forward_matches_jax(name, monkeypatch, restore_fused_flag):
    """The cls-only forward (its last block's k|v in one GEMM) equals the
    JAX package's, and counts one fused projection a full block, the CLS
    row's q and one k|v GEMM, and 2L + 1 LayerNorm calls."""
    jcfg, tcfg, jparams, _ = _route(name, monkeypatch, key=6)
    ln_calls = []
    for op in ("layernorm", "add_layernorm"):
        real = getattr(tvit.ln_ops, op)
        monkeypatch.setattr(tvit.ln_ops, op,
                            lambda *a, _real=real, **k: ln_calls.append(1) or _real(*a, **k))
    tokens = np.random.default_rng(10).standard_normal((2, 6, tcfg.hidden_size)).astype(np.float32)
    rope_np = tvit.rope_tables(tcfg, 2, 3)
    want = jvit.vit_forward_from_tokens(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tokens), jcfg,
        rope=tuple(jnp.asarray(t) for t in rope_np), cls_only=True)
    before = dict(tvit.projection_gemms)
    got = tvit.vit_forward_from_tokens(
        vit_params_from_numpy(jparams, tcfg), torch.from_numpy(tokens), tcfg,
        rope=tuple(torch.from_numpy(t) for t in rope_np), cls_only=True)
    assert got.shape == want.shape == (2, 1, tcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    made = {k: tvit.projection_gemms[k] - before[k] for k in before}
    assert made == {"qkv": tcfg.num_layers - 1, "q_cls": 1, "kv_cls": 1}
    assert len(ln_calls) == 2 * tcfg.num_layers + 1


def _shard(jparams, cfg, heads, prefix="layer.0"):
    """Block ``prefix``'s attention cut to its first ``heads`` heads, as a
    tensor-parallel shard holds them: q, k and v rows and the
    out-projection's columns."""
    names, flags, out_name, _ = jvit._attn_param_table(cfg, prefix)
    rows = heads * cfg.head_dim
    shard = dict(jparams)
    for name, flag in zip(names, flags):
        shard[f"{name}.weight"] = jparams[f"{name}.weight"][:rows]
        if flag:
            shard[f"{name}.bias"] = jparams[f"{name}.bias"][:rows]
    shard[f"{out_name}.weight"] = jparams[f"{out_name}.weight"][:, :rows]
    return shard


def test_odd_head_shard_takes_k3_on_views_and_matches_jax(monkeypatch, restore_fused_flag):
    """A tensor-parallel shard with 3 of 6 heads of 64 (an odd local count:
    the head-major route) fuses its own heads, (3 * 3 * 64, D), and its
    _attention and _attention_cls partials equal the JAX package's on the
    same slices."""
    kwargs = dict(BASE, hidden_size=384, num_heads=6)
    monkeypatch.delenv("CBAS_ATTN_FAT", raising=False)
    jvit.set_fused_attention(True)
    jcfg, tcfg = jvit.ViTConfig(**kwargs), tvit.ViTConfig(**kwargs)
    jparams = _shard(jax.device_get(jvit.init_vit_params(jax.random.key(7), jcfg)), jcfg, 3)
    params = tvit.fuse_qkv(params_to_device(jparams), tcfg)
    assert params["layer.0.attention.qkv.weight"].shape == (3 * 3 * 64, 384)
    x, rope_np = _inputs(tcfg, seed=11)
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    jrope = tuple(jnp.asarray(t) for t in rope_np)
    rope = tvit._full_rope_tables(tuple(torch.from_numpy(t) for t in rope_np),
                                  tcfg.num_prefix_tokens)
    calls = []
    real = fa.fused_attention
    monkeypatch.setattr(fa, "fused_attention",
                        lambda *a, **k: calls.append(a[:3]) or real(*a, **k))
    got = tvit._attention(params, "layer.0", torch.from_numpy(x), tcfg, rope)
    want = jvit._attention(jp, "layer.0", jnp.asarray(x), jcfg, rope=jrope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert len(calls) == 1 and calls[0][0].shape[1] == 3 and not calls[0][0].is_contiguous()
    got_cls = tvit._attention_cls(params, "layer.0", torch.from_numpy(x), tcfg, rope)
    want_cls = jvit._attention_cls(jp, "layer.0", jnp.asarray(x), jcfg, rope=jrope)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=ATOL, rtol=0)


def test_cls_block_makes_one_kv_gemm_over_every_token(monkeypatch):
    """``_attention_cls``: the CLS row's q from the fused weight's first row
    block, then k and v in one GEMM over every token with its contiguous
    rows [HD:3HD]."""
    cfg = tvit.ViTConfig(**BASE)
    params = vit_params_from_numpy(tvit.init_vit_params(1, cfg), cfg)
    x, rope_np = _inputs(cfg)
    linears = _spy_linear(monkeypatch)
    tvit._attention_cls(params, "layer.0", torch.from_numpy(x), cfg,
                        tvit._full_rope_tables(tuple(torch.from_numpy(t) for t in rope_np),
                                               cfg.num_prefix_tokens))
    w = params["layer.0.attention.qkv.weight"]
    D = cfg.hidden_size
    (xq, wq, _), (xkv, wkv, ykv), _ = linears  # q, k|v, the out-projection
    assert xq.shape[1] == 1 and wq.data_ptr() == w.data_ptr() and wq.shape == (D, D)
    assert xkv.shape[1] == x.shape[1] and wkv.shape == (2 * D, D) and wkv.is_contiguous()
    assert wkv.data_ptr() == w.data_ptr() + D * D * w.element_size()
    assert ykv.shape == (2, x.shape[1], 2 * D)


def test_encoder_fuses_each_model_shard_after_the_cut():
    """FrameEncoder on a (data 1, model 2) mesh of CPU shards: each shard
    holds its own heads' fused projection, the HF names views of it."""
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.parallel.mesh import make_mesh

    cfg = tvit.ViTConfig(**dict(BASE, num_heads=4, hidden_size=256))
    enc = FrameEncoder("e", params=tvit.init_vit_params(2, cfg), cfg=cfg,
                       compute_dtype=torch.float32,
                       mesh=make_mesh((1, 2), ("data", "model"), ["cpu"] * 2))
    for shard in enc._shards[0]:
        w = shard.params["layer.0.attention.qkv.weight"]
        q = shard.params["layer.0.attention.q_proj.weight"]
        assert w.shape == (3 * 128, 256) and q.shape == (128, 256)
        assert q.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    one = FrameEncoder("e", params=tvit.init_vit_params(2, cfg), cfg=cfg,
                       compute_dtype=torch.float32, device="cpu")
    planes = np.random.default_rng(3).integers(0, 256, (2, 32, 32), np.uint8)
    np.testing.assert_allclose(enc.encode_planes(planes).astype(np.float32),
                               one.encode_planes(planes).astype(np.float32), atol=2e-3)


# ---------------------------------------------------------------------------
# The kernels' output layout and K1 on views
# ---------------------------------------------------------------------------

def _fused(B, N, H, d, dtype=torch.float32, seed=12):
    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, N, 3 * H * d))
                           .astype(np.float32)).to(dtype)
    return qkv, [qkv[..., j * H * d:(j + 1) * H * d] for j in range(3)]


@pytest.mark.parametrize("entry", ["fat", "packed", "headmajor"])
def test_output_is_dense_in_q_order_with_a_view_round_trip(entry):
    """On views of one fused projection each wrapper returns a dense output
    laid out in q's dim order: K1 a contiguous (B, N, H*64), K2 and K3
    empty(B, N, G, w).transpose(1, 2), so the context's (B, N, H*d) form is
    a view of it; and bit for bit what it returns on contiguous copies."""
    B, N, H, d = 2, 37, 4, 64
    _, cols = _fused(B, N, H, d)
    if entry == "fat":
        ops, fn = cols, fa.fused_attention_fat
    elif entry == "packed":
        ops, fn = [c.view(B, N, H // 2, 2 * d).transpose(1, 2) for c in cols], \
            fa.fused_attention_packed
    else:
        ops, fn = [c.view(B, N, H, d).transpose(1, 2) for c in cols], fa.fused_attention
    got = fn(*ops, d ** -0.5, 31)
    assert got.shape == ops[0].shape and got.stride() == fa._dense_like(ops[0]).stride()
    if entry == "fat":
        assert got.is_contiguous()
    else:
        assert got.transpose(1, 2).is_contiguous()
        flat = got.transpose(1, 2).reshape(B, N, H * d)
        assert flat.data_ptr() == got.data_ptr() and flat.is_contiguous()
    assert torch.equal(got, fn(*(t.contiguous() for t in ops), d ** -0.5, 31))


def test_dense_like_keeps_dense_layouts_and_drops_holes():
    """``_dense_like``: a contiguous tensor's strides and a hole-free view's
    (contiguous inputs and views of flat projections see no change), and a
    view of a wider buffer laid out in its dim order without the holes."""
    t = torch.empty(2, 3, 5, 8)
    assert fa._dense_like(t).stride() == t.stride()
    flat_view = torch.empty(2, 5, 3 * 8).view(2, 5, 3, 8).transpose(1, 2)
    assert fa._dense_like(flat_view).stride() == flat_view.stride()
    fused_view = torch.empty(2, 5, 9 * 8)[..., 8:32].view(2, 5, 3, 8).transpose(1, 2)
    assert fa._dense_like(fused_view).stride() == (5 * 3 * 8, 8, 3 * 8, 1)
    out = fa._in_dense_order(fused_view, torch.ones(2, 3, 5, 8))
    assert out.stride() == (5 * 3 * 8, 8, 3 * 8, 1) and bool((out == 1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_takes_fused_views(dtype):
    """K1 reads the column blocks of one fused projection (row stride 3D)
    as it reads contiguous tensors, RoPE and NaN in the dead rows included."""
    B, N, H, d = 2, 40, 2, 64
    _, (q, k, v) = _fused(B, N, H, d, dtype)
    k[:, 33:] = float("nan")
    v[:, 33:] = float("nan")
    ang = np.random.default_rng(13).uniform(-3, 3, (N, d)).astype(np.float32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    got = fa.fused_attention_fat(q, k, v, 0.125, 33, cos, sin)
    want = fa.fused_attention_fat(q.contiguous(), k.contiguous(), v.contiguous(), 0.125, 33,
                                  cos, sin)
    assert got.is_contiguous() and bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.parametrize(
    "case,match",
    [
        ("last-dim stride 2", "the last dim must have stride 1"),
        ("misaligned row stride", "stride 132 of dim 1 is not a multiple of 16 bytes"),
        ("different strides", "must share strides"),
        ("overlapping rows", "stride 64 of dim 1 overlaps"),
        ("misaligned base", "k starts at"),
    ],
)
def test_k1_refuses_overlap_and_misalignment(case, match):
    """K1 takes views now, under K2's and K3's rule, and refuses on the CPU
    as on the card what the kernel cannot read."""
    B, N, D = 2, 8, 128
    base = torch.zeros(B * N * 3 * D + 64, dtype=torch.bfloat16)
    q = k = v = base[:B * N * D].view(B, N, D)
    if case == "last-dim stride 2":
        q = k = v = base[:B * N * 2 * D].view(B, N, 2 * D)[..., ::2]
    elif case == "misaligned row stride":
        q = k = v = torch.as_strided(base, (B, N, D), (N * 132, 132, 1))
    elif case == "different strides":
        k = base[:B * N * 2 * D].view(B, N, 2 * D)[..., :D]
    elif case == "overlapping rows":
        q = k = v = torch.as_strided(base, (B, N, D), (N * D, 64, 1))
    elif case == "misaligned base":
        k = base[1:1 + B * N * D].view(B, N, D)
    with pytest.raises(ValueError, match=match):
        fa.fused_attention_fat(q, k, v, 0.125)


# ---------------------------------------------------------------------------
# The TPU probe
# ---------------------------------------------------------------------------

def _probe_qkv_kernel():
    """``make_qkv_kernel`` of the probe's source, its ``pallas_call`` in
    interpret mode (the probe builds an encoder when it is imported)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    with open(PROBE) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_qkv_kernel")
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    namespace = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu, "_NEG_INF": -1e30}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBE, "exec"), namespace)
    return namespace["make_qkv_kernel"]


def test_plain_version_on_fused_views_matches_probe22():
    """K1's plain version on the q, k and v column blocks of one fused bf16
    (B, N, 3D) projection against probe22's kernel on the same buffer
    (RoPE on, 31 of 37 rows live, NaN in the dead k and v rows), within the
    module docstring's bound."""
    B, N, nv, D, d = 2, 37, 31, 256, 64
    scale = d ** -0.5
    rng = np.random.default_rng(14)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    qkv[:, nv:, D:] = np.nan  # the dead rows of k and v
    ang = rng.uniform(-np.pi, np.pi, (N, d)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    kern = _probe_qkv_kernel()(B, N, D, d, nv, 2)
    want = kern(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(cos * scale),
                jnp.asarray(sin * scale))
    want = np.asarray(want.astype(jnp.float32), np.float64)
    buf = torch.from_numpy(qkv).to(torch.bfloat16)
    q, k, v = (buf[..., j * D:(j + 1) * D] for j in range(3))
    got = fa.fused_attention_fat(q, k, v, scale, nv, torch.from_numpy(cos), torch.from_numpy(sin))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    got = got.double().numpy()

    def heads(t):  # (B, n, D) -> (B, H, n, d), float64
        return t.double().numpy().reshape(B, t.shape[1], D // d, d).transpose(0, 2, 1, 3)

    def terms(t):  # |x| |cos| + |x_partner| |sin| of each element
        a = np.abs(t)
        partner = np.concatenate([a[..., d // 2:], a[..., :d // 2]], -1)
        n = t.shape[-2]
        return a * np.abs(cos[:n]) + partner * np.abs(sin[:n])

    mq, mk, mv = terms(heads(q)), terms(heads(k[:, :nv])), np.abs(heads(v[:, :nv]))
    delta = 2.0 ** -6 * scale * (mq @ mk.swapaxes(-1, -2)).max(-1)  # (B, H, N): a row's bound
    vmax = mv.max(axis=(-2, -1))[..., None]
    tol = (np.expm1(2 * delta) + 2.0 ** -8) * vmax + 2 * 2.0 ** -8 * np.abs(
        want.reshape(B, N, D // d, d).transpose(0, 2, 1, 3)).max(-1)
    tol = tol.transpose(0, 2, 1)[..., None]  # (B, N, H, 1)
    err = np.abs(got - want).reshape(B, N, D // d, d)
    assert (err <= tol).all(), float((err / tol).max())
    assert err.max() > 0  # the two round at different points
