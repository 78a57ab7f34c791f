"""cbas_tpu_torch.ops.attention_batched against the TPU kernels it ports.

The plain version (what the wrapper runs on a CPU tensor) is held to each
probe body it ports, run through a ``pallas_call`` of the probe's own block
shapes in Pallas interpret mode: probe13's ``qk_kernel``,
``qk_batched_kernel`` and ``full_batched_kernel`` (RoPE outside by its jit'd
``rope_xla``, and without), probe16's ``full_batched_kernel``, probe21's
``make_batched_kernel`` (the factory itself, its ``pl.pallas_call`` bound to
interpret mode; the model's RoPE tables from ``cbas_tpu``'s
``_full_rope_tables``), probe26's ``batched_kernel``, ``batched_kt_kernel``
and ``fatq_kt_kernel``, and probe26b's ``gbbatch_kernel`` at gb 2 with RoPE
and without. The probes build and time their kernels when imported, so each
body is taken out of the source with ``ast`` and run with the globals it
reads, at a small size: 2 images of 4 heads of 64, N 72 with 67 live keys
(NaN in the dead k and v rows), two items a block. Inputs are standard
normal x 0.3, as the probes draw them.

The bound (``chip_smoke.batched_tolerance``, the card's bound for the
kernel, with one term added here) follows what each rounding point can move
(u = 2^-8, bf16's unit roundoff):

- the qk bodies return q: bit for bit;
- the scores: each side sums d exact bf16 products in fp32 in its own order,
  at most 2 ulps of the running sum an add: d 2^-22 sum_i |q_i k_i| |scale|,
  plus 2^-23 |s| for each side's product by the scale;
- RoPE in bf16 arithmetic (inside, or outside by ``rope_xla``): the port
  rounds each product and the sum (the probe's per-op form); XLA may keep the
  products in fp32 and round once. The two differ by at most 3u(1+u) T a
  roped element, T = |x||cos| + |rot(x)||sin| (times the bf16 scale where it
  follows); a score by 3u(1+u) |scale| (T_q . |k'| + |q'| . T_k + 3u(1+u) T_q
  . T_k);
- the row max by at most the largest score difference of its live keys;
  each p = exp(s - m) by a factor within e^(+-e), e the score's and the
  max's differences plus 2^-20 (1 + |s - m| + |m|) for the two
  exponentials; its bf16 P between the roundings of p e^-e and p e^e;
- the row sum by sum p expm1(e) plus nv 2^-22 of it (two fp32 orders); p.V
  by sum dP |v| plus nv 2^-22 sum (P + dP) |v|; the division by 2^-21 |o|;
  then one bf16 ulp of the output.

The same bound holds the plain version against an emulation of the kernel's
arithmetic in other summation orders (float64 sums, the exponential as
2^(s log2(e) - m log2(e)) by one fused multiply-add, P V times the
reciprocal row sum), and planted faults leave it: the scale left out, the
mask left out, and an online softmax whose rescale is dropped on a two-tile
row.

The ``cuda`` tests hold each option set's kernel against its plain version on
the card and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_batched.py
"""

import ast
import dataclasses
import functools
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu_torch.models.vit import PRESETS
from cbas_tpu_torch.ops import attention_batched as ab
from cbas_tpu_torch.ops import flash_attention as fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = os.path.join(ROOT, "benchmarks", "attn_probes")
B, H, N, NV, D_HEAD = 2, 4, 72, 67, 64
G, D = H // 2, H * D_HEAD
ITEMS = 2  # items a block (probe13's and 26's NH, probe26b's gb)
SCALE = D_HEAD ** -0.5
U = 2.0 ** -8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The TPU probes
# ---------------------------------------------------------------------------

def _pl():
    from jax.experimental import pallas as pl

    return pl


def _pltpu():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu


def _probe_fn(file, name, **globals_):
    """The function ``name`` out of a probe's source, with the globals it
    reads (the probe's constants at this test's size)."""
    path = os.path.join(PROBES, file)
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {"jax": jax, "jnp": jnp, "pl": _pl(), "pltpu": _pltpu(), "_NEG_INF": -1e30,
                 "N": N, "NV": NV, "d": D_HEAD, "scale": SCALE, **globals_}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), namespace)
    return namespace[name]


@functools.lru_cache(maxsize=None)
def _inputs():
    """Flat (B, N, D) q, k, v as float32 numpy exactly representable in bf16
    (standard normal x 0.3), NaN in k's and v's rows at or past NV; standard
    normal (N, 64) tables."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, D), np.float32) * 0.3)
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    k[:, NV:] = np.nan
    v[:, NV:] = np.nan
    cos, sin = (rng.standard_normal((N, D_HEAD)).astype(np.float32) for _ in range(2))
    return q, k, v, cos, sin


def _headmajor(t):  # flat (B, N, D) -> (B*H, N, 64)
    return t.reshape(B, N, H, D_HEAD).transpose(0, 2, 1, 3).reshape(B * H, N, D_HEAD)


def _packed(t):  # flat -> (B*G, N, 128) head-pair blocks
    return t.reshape(B, N, G, 2 * D_HEAD).transpose(0, 2, 1, 3).reshape(B * G, N, 2 * D_HEAD)


def _bf16(t):
    return jnp.asarray(t, jnp.bfloat16)


def _call(body, shapes, out_shape, out_block, inputs, grid, scratch=None):
    """``body`` through an interpret-mode pallas_call: block i of every
    operand is (block shape) at i along dim 0 (tables: the whole (N, 64))."""
    pl = _pl()

    def spec(shape):
        if len(shape) == 2:
            return pl.BlockSpec(shape, lambda i: (0, 0))
        return pl.BlockSpec(shape, lambda i: (i, 0, 0))

    kw = {"scratch_shapes": [_pltpu().VMEM(scratch, jnp.float32)]} if scratch else {}
    call = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.bfloat16),
                          grid=(grid,), in_specs=[spec(s) for s in shapes],
                          out_specs=spec(out_block), interpret=True, **kw)
    return np.asarray(call(*inputs).astype(jnp.float32), np.float64)


def _rope_xla(t, cos, sin, scale=None):
    """probe13's rope_xla (then x scale for q) under jit, as the probe runs it."""
    fn = _probe_fn("probe13_batched_dot_256.py", "rope_xla", cos=jnp.asarray(cos),
                   sin=jnp.asarray(sin))

    def run(x):
        y = fn(x)
        return y if scale is None else y * jnp.asarray(scale, x.dtype)

    return jax.jit(run)(t)


def _model_tables():
    """probe21's tables: cbas_tpu's _full_rope_tables over an 8 x 8 patch
    grid of dinov3-vitb16 (identity prefix rows, zero pad rows), times the
    scale in fp32."""
    from cbas_tpu.models import vit as jvit

    cfg = jvit.PRESETS["dinov3-vitb16"]
    rope = tuple(jnp.asarray(t) for t in jvit.rope_tables(cfg, 8, 8))
    cos, sin = jvit._full_rope_tables(rope, cfg.num_prefix_tokens, N)
    return np.array(cos, np.float32), np.array(sin, np.float32)


def _probe_out(case):
    """The probe body of ``case`` on :func:`_inputs`, as head-major (B, H, N,
    64) float64."""
    q, k, v, cos, sin = _inputs()
    hm = [_bf16(_headmajor(t)) for t in (q, k, v)]
    blocks3 = [(ITEMS, N, D_HEAD)] * 3
    out_hm = (B * H, N, D_HEAD)
    if case == "probe13 qk_kernel":
        body = _probe_fn("probe13_batched_dot_256.py", "qk_kernel", GP=ITEMS // 2)
        pk = [_bf16(_packed(t)) for t in (q, k, v)]
        out = _call(body, [(ITEMS // 2, N, 2 * D_HEAD)] * 3, (B * G, N, 2 * D_HEAD),
                    (ITEMS // 2, N, 2 * D_HEAD), pk, B * G * 2 // ITEMS, (ITEMS, N, N))
        return out.reshape(B, G, N, 2, D_HEAD).transpose(0, 1, 3, 2, 4).reshape(B, H, N, D_HEAD)
    if case == "probe13 qk_batched_kernel":
        body = _probe_fn("probe13_batched_dot_256.py", "qk_batched_kernel")
        out = _call(body, blocks3, out_hm, blocks3[0], hm, B * H // ITEMS, (ITEMS, N, N))
    elif case in ("probe13 full_batched_kernel", "probe16 full_batched_kernel",
                  "probe13 full_batched_kernel, RoPE outside",
                  "probe16 full_batched_kernel, RoPE outside"):
        file = "probe13_batched_dot_256.py" if "probe13" in case else \
            "probe16_variants_marginal_256.py"
        body = _probe_fn(file, "full_batched_kernel")
        if "RoPE" in case:
            hm = [_rope_xla(hm[0], cos, sin, SCALE), _rope_xla(hm[1], cos, sin), hm[2]]
        out = _call(body, blocks3, out_hm, blocks3[0], hm, B * H // ITEMS)
    elif case == "probe21 make_batched_kernel":
        pl = _pl()
        interp = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
        interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
        make = _probe_fn("probe21_batched_model_256.py", "make_batched_kernel", pl=interp)
        kern = make(B * H, N, D_HEAD, NV, ITEMS)
        c, s = _model_tables()
        out = np.asarray(kern(*hm, jnp.asarray(c * SCALE, jnp.float32),
                              jnp.asarray(s * SCALE, jnp.float32)).astype(jnp.float32), np.float64)
    elif case in ("probe26 batched_kernel", "probe26 batched_kt_kernel"):
        kt = case.endswith("kt_kernel")
        body = _probe_fn("probe26_layouts_256.py", "batched_kt_kernel" if kt else "batched_kernel")
        args = [hm[0], _bf16(_headmajor(k).transpose(0, 2, 1)), hm[2]] if kt else hm
        shapes = [blocks3[0], (ITEMS, D_HEAD, N), blocks3[0]] if kt else blocks3
        out = _call(body, shapes, out_hm, blocks3[0], args, B * H // ITEMS)
    elif case == "probe26 fatq_kt_kernel":
        gbh = ITEMS // H if ITEMS >= H else 1
        body = _probe_fn("probe26_layouts_256.py", "fatq_kt_kernel", GBH=gbh, H=H)
        t = [_bf16(_headmajor(x).transpose(0, 2, 1)) for x in (k, v)]
        out = _call(body, [(gbh, N, D), (gbh * H, D_HEAD, N), (gbh * H, D_HEAD, N)], out_hm,
                    (gbh * H, N, D_HEAD), [_bf16(q)] + t, B // gbh)
    elif case.startswith("probe26b"):
        rope = "RoPE" in case
        body = functools.partial(_probe_fn("probe26b_gbbatch_256.py", "gbbatch_kernel", G=G),
                                 gb=ITEMS, rope=rope)
        flat = _call(body, [(ITEMS, N, D)] * 3 + [(N, D_HEAD)] * 2, (B, N, D), (ITEMS, N, D),
                     [_bf16(t) for t in (q, k, v)] + [jnp.asarray(cos), jnp.asarray(sin)],
                     B // ITEMS)
        return flat.reshape(B, N, H, D_HEAD).transpose(0, 2, 1, 3)
    return out.reshape(B, H, N, D_HEAD)


# ---------------------------------------------------------------------------
# The port, on the same inputs, in each case's layout
# ---------------------------------------------------------------------------

def _port_case(case):
    """(operands, kwargs, extra_ds) of the port's call for ``case``: q, k, v
    in the probe's layout (head-major (B, H, N, 64) views, head-pair packed
    (B, G, 2, N, 64) ones, flat ones, K and V transposed), the options, and
    the RoPE term of the bound (module docstring) where the probe ropes."""
    q, k, v, cos, sin = (torch.from_numpy(t) for t in _inputs())
    qf, kf, vf = (t.to(torch.bfloat16) for t in (q, k, v))
    hm = [t.view(B, N, H, D_HEAD).transpose(1, 2).contiguous() for t in (qf, kf, vf)]
    kw = {"n_valid": NV, "items": ITEMS}
    extra = None
    if case == "probe13 qk_kernel":
        pk = [t.view(B, N, G, 2 * D_HEAD).transpose(1, 2).contiguous() for t in (qf, kf, vf)]
        ops = [t.view(B, G, N, 2, D_HEAD).transpose(2, 3) for t in pk]
        kw.update(stage="qk", n_valid=None)
    elif case == "probe13 qk_batched_kernel":
        ops = hm
        kw.update(stage="qk", n_valid=None)
    elif "full_batched_kernel" in case:
        ops = hm
        if "RoPE" in case:
            ops = [ab.rope_outside(hm[0], cos, sin, SCALE), ab.rope_outside(hm[1], cos, sin), hm[2]]
            cb, sb = cos.to(torch.bfloat16), sin.to(torch.bfloat16)
            extra = _rope_ds(hm[0], hm[1], (cb, sb, cb, sb), ops[0], ops[1], 1.0, q_factor=SCALE)
    elif case == "probe21 make_batched_kernel":
        c, s = (torch.from_numpy(t) for t in _model_tables())
        tables = ab.rope_tables(c, s, SCALE, D_HEAD ** 0.5)
        ops = hm
        kw["tables"] = tables
        extra = _rope_ds(hm[0], hm[1], tables, ab.rope_bf16(hm[0], *tables[:2]),
                         ab.rope_bf16(hm[1], *tables[2:]), 1.0)
    elif case == "probe26 batched_kernel":
        ops = hm
        kw["score_scale"] = SCALE
    elif case == "probe26 batched_kt_kernel":
        ops = [hm[0], hm[1].transpose(-1, -2).contiguous(), hm[2]]
        kw.update(score_scale=SCALE, k_transposed=True)
    elif case == "probe26 fatq_kt_kernel":
        ops = [qf.view(B, N, H, D_HEAD).transpose(1, 2)] + [
            t.transpose(-1, -2).contiguous() for t in hm[1:]]
        kw.update(score_scale=SCALE, k_transposed=True, v_transposed=True, items=H)
    else:  # probe26b gbbatch, flat views
        ops = [t.view(B, N, H, D_HEAD).transpose(1, 2) for t in (qf, kf, vf)]
        kw.update(score_scale=SCALE, items=ITEMS * H)
        if "RoPE" in case:
            kw["tables"] = ab.rope_tables(cos, sin)
            extra = _rope_ds(ops[0], ops[1], kw["tables"], ab.rope_bf16(ops[0], *kw["tables"][:2]),
                             ab.rope_bf16(ops[1], *kw["tables"][2:]), SCALE)
    return ops, kw, extra


def _rope_ds(q, k, tables, q_roped, k_roped, score_scale, q_factor=1.0):
    """The module docstring's RoPE term of a score's bound: 3u(1+u) |scale|
    (T_q . |k'| + |q'| . T_k + 3u(1+u) T_q . T_k), dead k rows left out."""
    cq, sq, ck, sk = (t.float() for t in tables)

    def terms(x, c, s):
        x = x.float()
        return x.abs() * c.abs() + fa.rotate_half(x).abs() * s.abs()

    live = (torch.arange(N) < NV)[:, None]
    tq = terms(q, cq, sq) * q_factor
    tk = torch.where(live, terms(k, ck, sk), 0.0)
    qa = q_roped.float().abs()
    ka = torch.where(live, k_roped.float().abs(), 0.0)
    r = 3 * U * (1 + U)
    return abs(score_scale) * r * (tq @ ka.transpose(-1, -2) + qa @ tk.transpose(-1, -2)
                                   + r * tq @ tk.transpose(-1, -2))


def _heads(t):
    """A port operand or output as head-major (B, H, N, 64)."""
    return t.reshape(B, H, N, D_HEAD) if t.dim() == 5 else t


PROBE_CASES = ["probe13 qk_kernel", "probe13 qk_batched_kernel", "probe13 full_batched_kernel",
               "probe13 full_batched_kernel, RoPE outside", "probe16 full_batched_kernel",
               "probe16 full_batched_kernel, RoPE outside", "probe21 make_batched_kernel",
               "probe26 batched_kernel", "probe26 batched_kt_kernel", "probe26 fatq_kt_kernel",
               "probe26b gbbatch_kernel gb 2", "probe26b gbbatch_kernel gb 2, RoPE"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_plain_version_matches_the_probe_body(case):
    """Each plain version against its probe body (interpret mode), within
    the module docstring's bound; the qk bodies bit for bit."""
    ops, kw, extra = _port_case(case)
    out = None
    if case == "probe26 fatq_kt_kernel":  # the probe's head-major output
        out = torch.empty(B * H, N, D_HEAD, dtype=torch.bfloat16).view(B, H, N, D_HEAD)
    got = ab.attention_batched(*ops, out=out, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == ops[0].shape
    if out is not None:
        assert got.data_ptr() == out.data_ptr()
    else:
        assert got.stride() == fa._dense_like(ops[0]).stride()
    want = _probe_out(case)
    got64 = _heads(got).double().numpy()
    assert np.isfinite(got64).all() and np.isfinite(want).all()
    if kw.get("stage") == "qk":
        assert np.array_equal(got64, want)
        return
    plain = _heads(ab.attention_batched_reference(
        *ops, kw["n_valid"], kw.get("score_scale", 1.0), kw.get("tables"),
        k_transposed=kw.get("k_transposed", False), v_transposed=kw.get("v_transposed", False)))
    tol = chip_smoke.batched_tolerance(
        torch, ab, *(_heads(t) for t in ops), NV, kw.get("score_scale", 1.0), kw.get("tables"),
        kw.get("k_transposed", False), kw.get("v_transposed", False), plain, extra)
    err = np.abs(got64 - want)
    assert (err <= tol.double().numpy()).all(), float((err / tol.double().numpy()).max())


def test_layouts_and_items_give_the_same_function():
    """One set of heads through every layout the wrapper takes (head-major,
    flat views, packed head pairs, K and V transposed, a head-major out) and
    any items a block: the same bits."""
    ops, _, _ = _port_case("probe26 batched_kernel")
    q, k, v = ops
    want = ab.attention_batched(q, k, v, NV, SCALE)
    flat = [t.transpose(1, 2).contiguous().view(B, N, D).view(B, N, H, D_HEAD).transpose(1, 2)
            for t in ops]
    packed = [t.reshape(B, G, 2, N, D_HEAD) for t in ops]
    out = torch.empty(B * H, N, D_HEAD, dtype=torch.bfloat16).view(B, H, N, D_HEAD)
    for got in (ab.attention_batched(*flat, NV, SCALE, items=5),
                _heads(ab.attention_batched(*packed, NV, SCALE)),
                ab.attention_batched(q, k.transpose(-1, -2).contiguous(),
                                     v.transpose(-1, -2).contiguous(), NV, SCALE,
                                     k_transposed=True, v_transposed=True, out=out)):
        assert torch.equal(got, want)
    assert ab.attention_batched(*flat, NV, SCALE).stride() == fa._dense_like(flat[0]).stride()


def test_rope_outside_is_probe13s_rope_xla():
    """rope_outside (plain torch) against probe13's rope_xla under jit: each
    roped element within the docstring's 3u(1+u) T (the same where XLA keeps
    the per-op roundings)."""
    q, _, _, cos, sin = _inputs()
    hm = _headmajor(q)
    want = np.asarray(_rope_xla(_bf16(hm), cos, sin, SCALE).astype(jnp.float32), np.float64)
    t = torch.from_numpy(hm).to(torch.bfloat16)
    got = ab.rope_outside(t, torch.from_numpy(cos), torch.from_numpy(sin), SCALE).double().numpy()
    cb, sb = (torch.from_numpy(x).to(torch.bfloat16).double().numpy() for x in (cos, sin))
    x = hm.astype(np.float64)
    rot = np.concatenate([-x[..., 32:], x[..., :32]], -1)
    terms = (np.abs(x) * np.abs(cb) + np.abs(rot) * np.abs(sb)) * SCALE
    assert (np.abs(got - want) <= 3 * U * (1 + U) * terms).all()


# ---------------------------------------------------------------------------
# chip_smoke.py's bound against an emulation of the kernel
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _emulated_kernel(q, k, v, nv, score_scale, tables, fault=None):
    """The kernel's arithmetic on head-major operands, in its own orders:
    the scores summed in float64 and rounded once, times the scale in fp32,
    the exponential as 2^x of x = s log2(e) - m log2(e) (one fused
    multiply-add, m log2(e) rounded to fp32), the row sums and p.V in
    float64, O times the reciprocal row sum. ``fault``: "no_scale" (the scale
    left out), "no_mask" (dead keys not masked: their zero scores join the
    softmax), "online_no_rescale" (64-key tiles against a running max whose
    rises do not rescale the sum or O)."""
    qh, kh = q, k
    if tables is not None:
        qh, kh = ab.rope_bf16(q, *tables[:2]), ab.rope_bf16(k, *tables[2:])
    live = torch.arange(q.shape[-2]) < nv
    kh = torch.where(live[:, None], kh.double(), 0.0)
    vh = torch.where(live[:, None], v.double(), 0.0)
    s = (qh.double() @ kh.transpose(-1, -2)).float()
    if fault != "no_scale":
        s = s * score_scale
    if fault != "no_mask":
        s = torch.where(live, s, ab.MASKED)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)

    def weights(st, m):
        x = (st.double() * float(log2e) - (m * log2e).double()).float()
        return torch.exp2(x.double()).float()

    if fault == "online_no_rescale":
        m = torch.full(s.shape[:-1] + (1,), -math.inf)
        acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), dtype=torch.float64)
        lsum = torch.zeros(s.shape[:-1] + (1,), dtype=torch.float64)
        for k0 in range(0, s.shape[-1], 64):
            st = s[..., k0:k0 + 64]
            m = torch.maximum(m, st.amax(-1, keepdim=True))
            p = weights(st, m)
            acc = acc + p.to(torch.bfloat16).double() @ vh[..., k0:k0 + 64, :]
            lsum = lsum + p.double().sum(-1, keepdim=True)
        return (acc.float() * (1.0 / lsum.float())).to(torch.bfloat16)
    p = weights(s, s.amax(-1, keepdim=True))
    lsum = p.double().sum(-1, keepdim=True).float()
    return ((p.to(torch.bfloat16).double() @ vh).float() * (1.0 / lsum)).to(torch.bfloat16)


def _bound_case(name):
    """Head-major operands at the main shapes' widths (cut to 2 x 4 items):
    probe26's scale on the scores at N 272 / 261, probe21's RoPE inside with
    the model's tables at N 261, both from chip_smoke.batched_inputs."""
    case = next(c for c in chip_smoke.BATCHED_CASES if c["what"] == name)
    case = dict(case, B=2, H=4)
    inputs = chip_smoke.batched_inputs(torch, PRESETS["dinov3-vitb16"], case, "cpu")
    q, k, v = inputs["heads"]
    kernel, plain, tables, scale = chip_smoke.batched_calls(ab, dict(case, inputs="headmajor"),
                                                            dict(inputs, q=q, k=k, v=v),
                                                            case["rope"] is not None)
    want = plain()
    tol = chip_smoke.batched_tolerance(torch, ab, q, k, v, case["nv"], scale, tables, False,
                                       False, want)
    return (q, k, v, case["nv"], scale, tables), want, tol


BOUND_CASES = ["probe26 batched_kernel", "probe21 make_batched_kernel"]


@pytest.mark.parametrize("case", BOUND_CASES)
def test_batched_tolerance_covers_the_kernels_arithmetic(case):
    """chip_smoke's card bound holds between the plain version and the
    kernel's arithmetic emulated in other orders, and is a few output ulps."""
    args, want, tol = _bound_case(case)
    got = _emulated_kernel(*args)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and (err <= tol).all(), float((err / tol).max())
    ulp = chip_smoke.dtype_ulp(torch, want.float())
    assert float((tol / ulp).median()) < 3  # 1.0-2.0 here


FAULTS = [("probe26 batched_kernel", fault) for fault in ("no_scale", "no_mask",
                                                          "online_no_rescale")] + [
    ("probe21 make_batched_kernel", fault) for fault in ("no_scale", "online_no_rescale")]


@pytest.mark.parametrize("case,fault", FAULTS)
def test_batched_tolerance_catches_a_planted_fault(case, fault):
    """A kernel with one planted mistake leaves chip_smoke's bound. (probe21's
    scale sits in its q tables: its "no_scale" is the tables' scale left out;
    its keys are all live, so it has no mask to leave out.)"""
    args, want, tol = _bound_case(case)
    q, k, v, nv, scale, tables = args
    if fault == "no_scale" and tables is not None:
        c = tables[0].float() / SCALE
        s = tables[1].float() / SCALE
        args = (q, k, v, nv, scale, (c.to(torch.bfloat16), s.to(torch.bfloat16)) + tables[2:])
    got = _emulated_kernel(*args, fault=None if fault == "no_scale" and tables else fault)
    err = (got.float() - want.float()).abs()
    assert (err > tol).any(), float((err / tol).max())


def test_online_rescale_fault_needs_a_two_tile_row():
    """The planted online fault bites only where a row's max rises in its
    second key tile: on one tile (N <= 64) it is the exact softmax."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 60, 64), np.float32) * 0.3)
               .to(torch.bfloat16) for _ in range(3))
    assert torch.equal(_emulated_kernel(q, k, v, 60, SCALE, None, "online_no_rescale"),
                       _emulated_kernel(q, k, v, 60, SCALE, None))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    ("float32", "built for bfloat16"),
    ("head dim 128", "built at head dim 64"),
    ("N 384", "exceeds the 320 rows"),
    ("n_valid 0", "outside"),
    ("items 0", "items must be at least 1"),
    ("qk with tables", "not built for qk\\+rope"),
    ("rope with kT", "not built for full\\+rope\\+kT"),
    ("v transposed alone", "not built for full\\+vT"),
    ("unknown stage", "stage must be one of"),
    ("3-dim q", "expected \\(B, H, N, 64\\)"),
    ("k of another shape", "does not match"),
    ("table shape", "each table must be bf16"),
    ("misaligned base", "k starts at"),
    ("strided last dim", "the last dim must have stride 1"),
    ("sT without tables", "not built for full\\+sT"),
    ("split without tables", "not built for split"),
    ("noexp on the full stage", "not built for full\\+rope\\+noexp"),
    ("qk with sT", "not built for qk\\+sT"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """On the CPU as on the card: the refusals come before the plain version.
    Each operand is held to the stride rule on its own (q, k and v need not
    share strides)."""
    q = k = v = torch.zeros(2, 4, 16, 64, dtype=torch.bfloat16)
    kw = {}
    if case == "float32":
        q = k = v = q.float()
    elif case == "head dim 128":
        q = k = v = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)
    elif case == "N 384":
        q = k = v = torch.zeros(1, 1, 384, 64, dtype=torch.bfloat16)
    elif case == "n_valid 0":
        kw["n_valid"] = 0
    elif case == "items 0":
        kw["items"] = 0
    elif case == "qk with tables":
        kw.update(stage="qk", tables=ab.rope_tables(torch.ones(16, 64), torch.zeros(16, 64)))
    elif case == "rope with kT":
        k = k.transpose(-1, -2).contiguous()
        kw.update(k_transposed=True,
                  tables=ab.rope_tables(torch.ones(16, 64), torch.zeros(16, 64)))
    elif case == "v transposed alone":
        v = v.transpose(-1, -2).contiguous()
        kw["v_transposed"] = True
    elif case == "unknown stage":
        kw["stage"] = "pv"
    elif case == "3-dim q":
        q = k = v = q[0]
    elif case == "k of another shape":
        k = torch.zeros(2, 4, 17, 64, dtype=torch.bfloat16)
    elif case == "table shape":
        kw["tables"] = ab.rope_tables(torch.ones(15, 64), torch.zeros(15, 64))
    elif case == "misaligned base":
        base = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
        k = base[1:1 + q.numel()].view(q.shape)
    elif case == "strided last dim":
        v = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)[..., ::2]
    elif case == "sT without tables":
        kw["transposed_scores"] = True
    elif case == "split without tables":
        kw["stage"] = "split"
    elif case == "noexp on the full stage":
        kw.update(noexp=True, tables=ab.rope_tables(torch.ones(16, 64), torch.zeros(16, 64)))
    elif case == "qk with sT":
        kw.update(stage="qk", transposed_scores=True)
    with pytest.raises(ValueError, match=match):
        ab.attention_batched(q, k, v, **kw)


def test_operands_take_strides_of_their_own():
    """q a flat view, k and v transposed and contiguous: strides differ
    between operands, and each is taken."""
    ops, kw, _ = _port_case("probe26 fatq_kt_kernel")
    assert len({t.stride() for t in ops}) == 2
    assert ab.attention_batched(*ops, **kw).shape == ops[0].shape


def test_kernel_path_refuses_a_cpu_tensor():
    """The kernel path never runs the plain version: a CPU tensor there raises."""
    t = torch.zeros(1, 1, 1, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ab._launch(t, t, t, t, 16, 1.0, None, "full", False, False, 16)


def test_launches_count_kernel_launches_only(monkeypatch):
    """CPU calls never count; each kernel launch counts once, by option set."""
    monkeypatch.setattr(ab, "launches", 0)
    monkeypatch.setattr(ab, "launches_by_option", {})
    t = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    ab.attention_batched(t, t, t)
    ab.attention_batched(t, t, t, stage="qk")
    assert ab.launches == 0 and ab.launches_by_option == {}
    for name in ("full+rope", "full+rope", "qk"):
        ab._count_launch(name)
    assert ab.launches == 3 and ab.launches_by_option == {"full+rope": 2, "qk": 1}
    assert [ab.option_set(*o) for o in sorted(ab.BUILT)] == [
        "full", "full+kT", "full+kT+vT", "full+rope", "full+rope+sT", "qk", "split+rope",
        "split+rope+noexp", "split+rope+sT", "split+rope+sT+noexp"]


def test_no_encode_route_calls_the_batched_kernel():
    """The kernel is a timing kernel: no module of the port's models or
    engine names it (chip_smoke.py swaps it into the model for its A/B)."""
    pkg = os.path.join(ROOT, "cbas_tpu_torch")
    for sub in ("models", "engine", "app", "parallel", "tools"):
        for dirpath, _, files in os.walk(os.path.join(pkg, sub)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        text = fh.read()
                    assert "attention_batched" not in text and "relayout" not in text, f


# ---------------------------------------------------------------------------
# chip_smoke.py's batched phase
# ---------------------------------------------------------------------------

def _cut_cases():
    cut = []
    for c in chip_smoke.BATCHED_CASES:
        c = dict(c, B=2, H=4 if c["inputs"] != "fused" else 2)
        if c["inputs"] != "fused":  # fused keeps the model's N 261 (a 16 x 16 grid)
            c.update(N=72, nv=72 if c["nv"] == c["N"] else 67, items=max(1, c["items"] // 8))
        cut.append(c)
    return tuple(cut)


def test_chip_smoke_batched_phase_runs_on_cpu(monkeypatch):
    """The batched phase at a cut size, the plain versions on both sides:
    every check holds, the model A/B through a cut dinov3 encoder agrees with
    the K1 route, and nothing is counted."""
    monkeypatch.setattr(chip_smoke, "BATCHED_CASES", _cut_cases())
    monkeypatch.setattr(chip_smoke, "RELAYOUT_SHAPE", (2, 72, 4, 64, 67))
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    cfg = dataclasses.replace(PRESETS["dinov3-vitb16"], hidden_size=128, num_heads=2,
                              num_layers=2, intermediate_size=256)
    out = chip_smoke.batched_phase(torch, cfg, device="cpu")
    assert out["launches"] == {} and out["launches_relayout"] == 0
    assert len(out["cases"]) == len(chip_smoke.BATCHED_CASES)
    for c, spec in zip(out["cases"], chip_smoke.BATCHED_CASES):
        assert c["ok"] and set(c["ropes"]) == {"rope" if r else "no_rope" for r in spec["ropes"]}
        for e in c["ropes"].values():
            assert e["launches"] == 0
    assert out["relayout"]["bit_equal"] and out["model"]["ok"]
    assert out["model"]["min_cos_vs_k1"] >= chip_smoke.BATCHED_MODEL_MIN_COS
    flat = out["flat_model"]  # probes 20, 21 and 24: both routes against K1's
    assert flat["ok"] and set(flat["routes"]) == set(chip_smoke.FLAT_MODEL_ROUTES)
    assert all(r["launches_a_forward"] == 0 and r["min_cos_vs_k1"] >= chip_smoke.BATCHED_MODEL_MIN_COS
               for r in flat["routes"].values())


def test_batched_cases_are_the_probes_shapes():
    """Every site of the port is a case at its probe's own shape: probe13's
    and 16's (384, 12, 272) with 261 live keys (the qk bodies unmasked),
    probe21's (384, 12, 261) on fused views, probe26's and 26b's (448, 12,
    272); 16 items a block, probe26's fatq and 26b's gb images' heads."""
    cases = {c["what"]: c for c in chip_smoke.BATCHED_CASES}
    for c in cases.values():
        assert (c["B"], c["H"]) in ((384, 12), (448, 12))
        body = c["body"].split(",")[0].split(":")[0]
        assert any(site.split("/")[-1].startswith(body.split(":")[0])
                   for site in chip_smoke.BATCHED_SITES), c
    assert cases["probe21 make_batched_kernel"]["inputs"] == "fused"
    assert cases["probe21 make_batched_kernel"]["N"] == 261
    assert [cases[f"probe26b gbbatch_kernel gb {gb}"]["items"] for gb in (4, 8)] == [48, 96]
    assert cases["probe26b gbbatch_kernel gb 4"]["ropes"] == (True, False)
    assert cases["probe13/16 full_batched_kernel"]["rope"] == "outside"
    assert chip_smoke.BATCHED_HEADLINE in cases
    assert chip_smoke.BATCHED_FLOOR_CASE == chip_smoke.FLOOR_SHAPES[0][0]
    assert chip_smoke.FLOOR_SHAPES[0][1] == (384 * 6, 272, 128)


def test_batched_attention_swaps_only_inside_the_model_case():
    """chip_smoke's probe21 route runs the batched kernel's plain version on
    the CPU with probe21's tables and leaves vit._attention as it was."""
    from cbas_tpu_torch.models import vit

    before = vit._attention
    cfg = dataclasses.replace(PRESETS["dinov3-vitb16"], hidden_size=128, num_heads=2,
                              num_layers=2, intermediate_size=256)
    from cbas_tpu_torch.models.encoder import FrameEncoder

    enc = FrameEncoder("dinov3-vitb16", cfg=cfg, random_init=True, device="cpu")
    planes = np.random.default_rng(0).integers(0, 256, (2, 64, 64), np.uint8)
    out = chip_smoke.batched_model_case(torch, enc, planes, 2, device="cpu")
    assert vit._attention is before and out["ok"]


def test_ptxas_labels_name_the_option_sets():
    """chip_smoke names each instantiation of the batched kernel by its
    option set, and the relayout by its kernel."""
    mangled = ("_ZN53_GLOBAL__N__1d417218_20_attention_batched_cu_f2d782ef17attention_batchedILi{}"
               "ELb{}ELb{}ELb{}EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE")
    assert chip_smoke.kernel_label(mangled.format(0, 1, 0, 0)) == "batched<full+rope>"
    assert chip_smoke.kernel_label(mangled.format(0, 0, 1, 1)) == "batched<full+kT+vT>"
    assert chip_smoke.kernel_label(mangled.format(1, 0, 0, 0)) == "batched<qk>"
    assert chip_smoke.kernel_label(
        "_ZN44_GLOBAL__N__ecdc4336_11_relayout_cu_9aa3d56e11relayout_ktEPKtPtiixx") == "relayout_kt"
    assert chip_smoke.batched_label("full", False, True, False) == "batched<full+kT>"
    # the transposed scores and noexp, two template arguments more; a set
    # without them compares equal to its name in a checkout before them
    new = mangled.replace("ELb{}EEEv", "ELb{}ELb{}ELb{}EEEv")
    assert chip_smoke.kernel_label(new.format(0, 1, 0, 0, 1, 0)) == "batched<full+rope+sT>"
    assert chip_smoke.kernel_label(new.format(2, 1, 0, 0, 1, 1)) == "batched<split+rope+sT+noexp>"
    assert chip_smoke.kernel_label(new.format(2, 1, 0, 0, 0, 0)) == "batched<split+rope>"
    assert chip_smoke.comparable_name(new.format(0, 1, 0, 0, 0, 0)) == \
        chip_smoke.comparable_name(mangled.format(0, 1, 0, 0))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", [c["what"] for c in chip_smoke.BATCHED_CASES])
def test_each_case_holds_its_plain_version_on_card(case, cuda_device):
    """Every batched case's kernel at a cut size (2 images) against its
    plain version (chip_smoke.batched_check: the qk stage bit for bit q, the
    full stage within batched_tolerance), one launch a call, RoPE on and off."""
    spec = next(c for c in chip_smoke.BATCHED_CASES if c["what"] == case)
    spec = dict(spec, B=2)
    inputs = chip_smoke.batched_inputs(torch, PRESETS["dinov3-vitb16"], spec, cuda_device)
    for rope in spec["ropes"]:
        kernel, _, tables, scale = chip_smoke.batched_calls(ab, spec, inputs, rope)
        before = ab.launches
        got = kernel()
        torch.cuda.synchronize()
        assert ab.launches == before + 1
        q, k = inputs["q"], inputs["k"]
        if rope and spec["rope"] == "outside":
            q = ab.rope_outside(q, inputs["cos"], inputs["sin"], D_HEAD ** -0.5)
            k = ab.rope_outside(k, inputs["cos"], inputs["sin"])
        check = chip_smoke.batched_check(torch, ab, spec, q, k, inputs["v"], scale, tables, got)
        assert check["ok"], (case, rope, check)
