"""The batched kernel's flat-probe, transposed-score and split options
against the TPU kernels they port.

The plain version (what ``attention_batched`` runs on a CPU tensor) is held
to each probe body, run through the probe's own ``pallas_call`` in Pallas
interpret mode (the factory or ``make`` function taken out of the source
with ``ast``, its ``pl.pallas_call`` bound to ``interpret=True``):

- probe18's ``fat_kernel`` (std, pvt), probe18b's ``fat_kernel`` and
  ``fat_kernel_unroll`` through their ``make_fat``: flat (B, N, 4 x 64)
  blocks of gb images, RoPE inside (q's tables times the scale, k's plain);
- probe19's ``kernel`` (std, pvt) through ``make``: a grid over head pairs,
  the port's items in (pair, image, head) order on (G, B, 2, N, 64) views;
- probe20's and probe21's ``make_fat_kernel`` factories with the model's
  tables (cbas_tpu's ``_full_rope_tables``) times the scale;
- probe12's ``phase_kernel`` through ``make_phase`` at every ``pvt x noexp``
  setting, on packed (B*G, N, 128) blocks: the split stage;
- probe24's body through ``cbas_tpu``'s ``fused_attention_fat(...,
  pvt=..., interpret=True)``: ``_fat_kernel_pairrope`` is ``_fat_kernel``
  (an ``ast`` comparison below), so K1's Pallas body is the site.

The size and inputs are ``test_torch_attention_batched``'s (2 images of 4
heads of 64, N 72 with 67 live keys, NaN in the dead k and v rows, two
images a program), and so is the bound (``chip_smoke.batched_tolerance``
with the RoPE term of that module's docstring; its ``noexp`` form for p = s
- m). The transposed orientation is the same function: s^T = k . q^T,
reduced down its columns.

The bound also holds the plain version against the kernel's column
reductions emulated in their own order (within a thread across the key
tiles, shuffles across the eight row groups, the four warps in pairs), and
planted faults leave it: a column sum over one warp's 16 keys of each tile,
``noexp`` with the dead keys left out of the sum, and the split stage with
the mask left out.

The ``cuda`` tests of ``tests/test_torch_attention_batched.py`` hold each
new option set against its plain version on the card (its cases are
``chip_smoke.BATCHED_CASES``).
"""

import ast
import functools
import inspect
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import test_torch_attention_batched as tb
from cbas_tpu_torch.models.vit import PRESETS
from cbas_tpu_torch.ops import attention_batched as ab

B, H, N, NV, D_HEAD, G, D = tb.B, tb.H, tb.N, tb.NV, tb.D_HEAD, tb.G, tb.D
GB = tb.ITEMS  # images a program of the flat probes; head pairs a program of probe12: GB // 2
SCALE = tb.SCALE
LOG2E = 1.4426950408889634


def _interpret_pl():
    """``jax.experimental.pallas`` with ``pallas_call`` bound to interpret mode."""
    pl = tb._pl()
    ns = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return ns


def _flat_inputs():
    q, k, v, cos, sin = tb._inputs()
    return [tb._bf16(t) for t in (q, k, v)], jnp.asarray(cos), jnp.asarray(sin)


def _as_heads(flat):
    """A flat (B, N, D) probe output as head-major (B, H, N, 64) float64."""
    return np.asarray(flat.astype(jnp.float32), np.float64).reshape(B, N, H, D_HEAD).transpose(
        0, 2, 1, 3)


def _flat_probe_out(case):
    """The flat probe body of ``case`` on the test inputs, head-major."""
    (qf, kf, vf), cos, sin = _flat_inputs()
    pvt = case.endswith("pvt")
    interp = _interpret_pl()
    common = dict(B=B, N=N, D=D, G=G, GB=GB, functools=functools, qf=qf, cos=cos, sin=sin,
                  pl=interp)
    if case.startswith(("probe18 ", "probe18b ")):
        file = "probe18_fat768_256.py" if case.startswith("probe18 ") else "probe18b_unroll_256.py"
        name = "fat_kernel_unroll" if "unroll" in case else "fat_kernel"
        body = tb._probe_fn(file, name, G=G, GB=GB)
        out = tb._probe_fn(file, "make_fat", **common)(body, pvt=pvt)(qf, kf, vf)
    elif case.startswith("probe19"):
        body = tb._probe_fn("probe19_fat_gridpair_256.py", "kernel", GB=GB)
        out = tb._probe_fn("probe19_fat_gridpair_256.py", "make", kernel=body, **common)(pvt)(
            qf, kf, vf)
    else:  # probe20's / probe21's factory, the model's tables times the scale
        c, s = (jnp.asarray(t * SCALE, jnp.float32) for t in tb._model_tables())
        if case.startswith("probe20"):
            make = tb._probe_fn("probe20_fat_model_256.py", "make_fat_kernel", pl=interp)
            kern = make(B, N, D, D_HEAD, NV, GB, pvt)
        else:
            make = tb._probe_fn("probe21_batched_model_256.py", "make_fat_kernel", pl=interp)
            kern = make(B, N, D, D_HEAD, NV, GB)
        out = kern(qf, kf, vf, c, s)
    return _as_heads(out)


def _probe12_out(pvt, noexp):
    """probe12's make_phase (its pallas_call and jit'd reshapes) on packed
    (B, G, N, 128) blocks, GB // 2 head pairs a program, head-major."""
    q, k, v, cos, sin = tb._inputs()
    packed = [tb._bf16(t.reshape(B, N, G, 2 * D_HEAD).transpose(0, 2, 1, 3)) for t in (q, k, v)]
    gp = GB // 2
    body = tb._probe_fn("probe12_phase_split_256.py", "phase_kernel", GP=gp, NH=2 * gp)
    make = tb._probe_fn("probe12_phase_split_256.py", "make_phase", phase_kernel=body,
                        functools=functools, pl=_interpret_pl(), B=B, G=G, dd=2 * D_HEAD,
                        GP=gp, NH=2 * gp, q=packed[0], k=packed[1], v=packed[2],
                        cos=jnp.asarray(cos), sin=jnp.asarray(sin))
    out = np.asarray(make(pvt, noexp)(*packed).astype(jnp.float32), np.float64)
    return out.reshape(B, G, N, 2, D_HEAD).transpose(0, 1, 3, 2, 4).reshape(B, H, N, D_HEAD)


def _probe24_out(pvt):
    """cbas_tpu's fused_attention_fat (K1's Pallas body, probe24's
    _fat_kernel_pairrope) in interpret mode, head-major."""
    from cbas_tpu.ops import flash_attention as jfa

    (qf, kf, vf), cos, sin = _flat_inputs()
    return _as_heads(jfa.fused_attention_fat(qf, kf, vf, SCALE, n_valid=NV, rope_cos=cos,
                                             rope_sin=sin, pvt=pvt, interpret=True))


# ---------------------------------------------------------------------------
# The port on the same inputs
# ---------------------------------------------------------------------------

def _port(case):
    """(q, k, v operands in the case's layout, kwargs, head-major q and k,
    tables) of the port's call for ``case``."""
    q, k, v, cos, sin = (torch.from_numpy(t) for t in tb._inputs())
    flat = [t.to(torch.bfloat16) for t in (q, k, v)]
    if case.startswith(("probe20", "probe21")):
        cos, sin = (torch.from_numpy(t) for t in tb._model_tables())
    tables = ab.rope_tables(cos, sin, SCALE, D_HEAD ** 0.5)
    kw = dict(n_valid=NV, tables=tables, transposed_scores="pvt" in case or case.startswith(
        "probe21"), items=GB * H)
    heads = [t.view(B, N, H, D_HEAD).transpose(1, 2) for t in flat]
    if case.startswith("probe19"):
        ops = [t.view(B, N, G, 2, D_HEAD).permute(2, 0, 3, 1, 4) for t in flat]
        kw["items"] = GB * 2
    elif case.startswith("probe12"):
        packed = [t.view(B, N, G, 2 * D_HEAD).transpose(1, 2).contiguous() for t in flat]
        ops = [t.view(B, G, N, 2, D_HEAD).transpose(2, 3) for t in packed]
        kw.update(stage="split", noexp="noexp" in case, items=GB)
    else:
        ops = heads
    return ops, kw, heads, tables


def _heads(t, case):
    """A port output in ``case``'s layout as head-major (B, H, N, 64)."""
    if case.startswith("probe19"):  # (G, B, 2, N, 64) pair grid
        t = t.permute(1, 0, 2, 3, 4)
    return t.reshape(B, H, N, D_HEAD)


FLAT_CASES = ["probe18 fat_kernel std", "probe18 fat_kernel pvt", "probe18b fat_kernel std",
              "probe18b fat_kernel pvt", "probe18b fat_kernel_unroll pvt", "probe19 kernel std",
              "probe19 kernel pvt", "probe20 make_fat_kernel std", "probe20 make_fat_kernel pvt",
              "probe21 make_fat_kernel pvt"]
PROBE12_CASES = [f"probe12 phase_kernel {pvt}{', noexp' * noexp}"
                 for noexp in (False, True) for pvt in ("std", "pvt")]
PROBE24_CASES = ["probe24 fused_attention_fat std", "probe24 fused_attention_fat pvt"]


def _probe_out(case):
    if case.startswith("probe12"):
        return _probe12_out("pvt" in case, "noexp" in case)
    if case.startswith("probe24"):
        return _probe24_out(case.endswith("pvt"))
    return _flat_probe_out(case)


@pytest.mark.parametrize("case", FLAT_CASES + PROBE12_CASES + PROBE24_CASES)
def test_plain_version_matches_the_probe_body(case):
    """The port (its plain version) against the probe body in interpret mode
    within chip_smoke.batched_tolerance plus the RoPE term; the output dense
    in q's dim order (flat for the flat and pair-grid views)."""
    ops, kw, heads, tables = _port(case)
    got = ab.attention_batched(*ops, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == ops[0].shape
    assert got.stride() == tb.fa._dense_like(ops[0]).stride()
    want = _probe_out(case)
    got64 = _heads(got, case).double().numpy()
    assert np.isfinite(got64).all() and np.isfinite(want).all()
    plain = _heads(ab.attention_batched_reference(
        *ops, NV, 1.0, tables, stage=kw.get("stage", "full"),
        transposed_scores=kw["transposed_scores"], noexp=kw.get("noexp", False)), case)
    extra = tb._rope_ds(heads[0], heads[1], tables, ab.rope_bf16(heads[0], *tables[:2]),
                        ab.rope_bf16(heads[1], *tables[2:]), 1.0)
    tol = chip_smoke.batched_tolerance(torch, ab, *heads, NV, 1.0, tables, False, False, plain,
                                       extra, noexp=kw.get("noexp", False)).double().numpy()
    err = np.abs(got64 - want)
    assert (err <= tol).all(), float((err / tol).max())
    if kw.get("noexp"):  # the dead keys' -1e30 - m in the sum: |o| of order 1e-28
        assert 0 < np.abs(want).max() < 1e-25


def test_probe24_pairrope_body_is_k1s_pallas_body():
    """probe24's _fat_kernel_pairrope and cbas_tpu's _fat_kernel are one
    function: their ast is equal once the name, the annotations and the
    docstring are set aside."""
    from cbas_tpu.ops import flash_attention as jfa

    def bare(src, name):
        fn = next(n for n in ast.parse(src).body
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        fn.name, fn.returns = "f", None
        for a in fn.args.args + fn.args.kwonlyargs:
            a.annotation = None
        if fn.body and isinstance(fn.body[0], ast.Expr) and isinstance(
                getattr(fn.body[0], "value", None), ast.Constant):
            fn.body = fn.body[1:]
        return ast.dump(fn)

    with open(os.path.join(tb.PROBES, "probe24_pairrope_256.py")) as f:
        probe = bare(f.read(), "_fat_kernel_pairrope")
    assert probe == bare(inspect.getsource(jfa), "_fat_kernel")


def test_transposed_scores_is_the_same_function():
    """The plain version's two orientations differ only by their fp32
    summation orders: within the bound of each other, on every option."""
    ops, kw, heads, tables = _port("probe18 fat_kernel std")
    row = ab.attention_batched_reference(*heads, NV, 1.0, tables)
    col = ab.attention_batched_reference(*heads, NV, 1.0, tables, transposed_scores=True)
    tol = chip_smoke.batched_tolerance(torch, ab, *heads, NV, 1.0, tables, False, False, row)
    assert ((row.float() - col.float()).abs() <= tol).all()
    split = ab.attention_batched_reference(*heads, NV, 1.0, tables, stage="split")
    assert torch.equal(split, row)


# ---------------------------------------------------------------------------
# chip_smoke.py's bound against the kernel's reductions
# ---------------------------------------------------------------------------

def _kernel_order_column_sum(p):
    """The sum down the key axis (-2) of p (fp32, keys a multiple of 64) in
    the transposed kernel's order: a thread adds rows g8 and g8 + 8 of its
    warp's 16 in each tile, then the tile to its running sum; lanes across
    the eight row groups in a butterfly (xor 4, 8, 16); the four warps as
    (w0 + w1) + (w2 + w3). Every add in fp32."""
    *lead, K, Q = p.shape
    t = p.reshape(*lead, K // 64, 4, 2, 8, Q)  # (tile, warp, row half, row group, query)
    pair = t[..., 0, :, :] + t[..., 1, :, :]
    run = pair[..., 0, :, :, :]
    for kt in range(1, K // 64):
        run = run + pair[..., kt, :, :, :]
    g = run.reshape(*lead, 4, 2, 2, 2, Q)  # row group g8 = 4 b2 + 2 b1 + b0
    g = g[..., 0, :] + g[..., 1, :]  # xor 4: bit 0 of g8
    g = g[..., 0, :] + g[..., 1, :]  # xor 8
    g = g[..., 0, :] + g[..., 1, :]  # xor 16 -> (..., warp, query)
    return g  # per warp; the caller takes (w0 + w1) + (w2 + w3) or a fault


def _emulated(q, k, v, nv, tables, *, transposed, noexp=False, fault=None):
    """The kernel's arithmetic on head-major operands: RoPE in bf16, the
    scores of ceil(nv / 64) key tiles (K rows past nv read as zero, as the
    tensor map fills them) summed in float64 and rounded once, keys past nv
    -> -1e30, p = 2^(s log2(e) - m log2(e)) by one fused multiply-add (or p
    = s - m, keys past N adding nothing), P . V in float64 rounded once,
    divided by the sum. Sums: the transposed kernel's column order
    (:func:`_kernel_order_column_sum`), else float64 rounded once. ``fault``:
    "one_warp_sum" (each warp's o^T rows over its own 16 keys of each tile),
    "noexp_dead_left_out", "no_mask" (the dead keys' zero scores join the
    softmax)."""
    qh, kh = ab.rope_bf16(q, *tables[:2]), ab.rope_bf16(k, *tables[2:])
    n, K = q.shape[-2], 64 * math.ceil(nv / 64)
    keys = torch.arange(K)
    rows = lambda t: torch.cat([t.double(), torch.zeros(*t.shape[:-2], K - n, t.shape[-1],
                                                         dtype=torch.float64)], -2)[..., :K, :]
    kz = torch.where((keys < nv)[:, None], rows(kh), 0.0)
    vz = torch.where((keys < nv)[:, None], rows(v), 0.0)
    s = (kz @ qh.double().transpose(-1, -2)).float()  # (..., K keys, N queries)
    if fault != "no_mask":
        s = torch.where((keys < nv)[:, None], s, ab.MASKED)
    m = s.amax(-2, keepdim=True)
    if noexp:
        p = torch.where((keys < n)[:, None], s - m, 0.0)
        if fault == "noexp_dead_left_out":
            p_sum = torch.where((keys < nv)[:, None], p, 0.0)
        else:
            p_sum = p
    else:
        log2e = torch.tensor(LOG2E, dtype=torch.float32)
        x = (s.double() * float(log2e) - (m * log2e).double()).float()
        p = p_sum = torch.exp2(x.double()).float()
    if transposed:
        per_warp = _kernel_order_column_sum(p_sum)  # (..., 4, N)
        if fault == "one_warp_sum":
            l = per_warp.repeat_interleave(16, dim=-2)  # o^T row d divided by warp d // 16's
        else:
            l = ((per_warp[..., 0, :] + per_warp[..., 1, :])
                 + (per_warp[..., 2, :] + per_warp[..., 3, :]))[..., None, :]
        acc = (vz.transpose(-1, -2) @ p.to(torch.bfloat16).double()).float()  # o^T (..., d, N)
        return (acc / l).transpose(-1, -2).to(torch.bfloat16)
    l = p_sum.double().sum(-2).float()[..., :, None]
    acc = (p.to(torch.bfloat16).double().transpose(-1, -2) @ vz).float()
    return (acc / l).to(torch.bfloat16)


def _bound_case(name):
    """A chip_smoke.BATCHED_CASES case cut to 2 images of 4 heads at its
    own N (272, 261 live): head-major operands, its tables, the plain
    version and its card bound."""
    case = next(c for c in chip_smoke.BATCHED_CASES if c["what"] == name)
    case = dict(case, B=2, H=4)
    inputs = chip_smoke.batched_inputs(torch, PRESETS["dinov3-vitb16"], case, "cpu")
    q, k, v = inputs["heads"]
    _, _, tables, scale = chip_smoke.batched_calls(ab, case, dict(inputs, q=q, k=k, v=v), True)
    noexp = case.get("noexp", False)
    want = ab.attention_batched_reference(q, k, v, case["nv"], scale, tables, stage=case["stage"],
                                          transposed_scores=case.get("sT", False), noexp=noexp)
    tol = chip_smoke.batched_tolerance(torch, ab, q, k, v, case["nv"], scale, tables, False,
                                       False, want, noexp=noexp)
    return case, (q, k, v, case["nv"], tables), want, tol


BOUND_CASES = ["probe18 fat_kernel pvt", "probe12 phase_kernel std", "probe12 phase_kernel pvt",
               "probe12 phase_kernel std, noexp", "probe12 phase_kernel pvt, noexp"]


@pytest.mark.parametrize("name", BOUND_CASES)
def test_batched_tolerance_covers_the_kernels_reductions(name):
    """chip_smoke's card bound holds between the plain version and the
    kernel's arithmetic with its own reduction orders, and is a few ulps of
    the output."""
    case, args, want, tol = _bound_case(name)
    got = _emulated(*args, transposed=case.get("sT", False), noexp=case.get("noexp", False))
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and (err <= tol).all(), float((err / tol).max())
    ulp = chip_smoke.dtype_ulp(torch, want.float())
    assert float((tol / ulp).median()) < 3


@pytest.mark.parametrize("name,fault", [
    ("probe18 fat_kernel pvt", "one_warp_sum"), ("probe12 phase_kernel pvt", "one_warp_sum"),
    ("probe12 phase_kernel std, noexp", "noexp_dead_left_out"),
    ("probe12 phase_kernel pvt, noexp", "noexp_dead_left_out"),
    ("probe12 phase_kernel std", "no_mask"), ("probe12 phase_kernel pvt", "no_mask")])
def test_batched_tolerance_catches_a_planted_fault(name, fault):
    """A kernel with one planted mistake leaves chip_smoke's bound."""
    case, args, want, tol = _bound_case(name)
    got = _emulated(*args, transposed=case.get("sT", False), noexp=case.get("noexp", False),
                    fault=fault)
    err = (got.float() - want.float()).abs()
    assert (err > tol).any(), float((err / tol).max())


# ---------------------------------------------------------------------------
# chip_smoke.py's cases
# ---------------------------------------------------------------------------

def test_new_cases_are_the_probes_shapes():
    """The flat probes at (384, 12, 272 / 261) in 48-item (gb 4) blocks,
    probe19 on its pair grid at 16 items, probe12's four settings on packed
    blocks at 16 heads a program; the flat floor at probe18's blocks; the
    flat model A/B at the probes' batch with 48 items a block."""
    cases = {c["what"]: c for c in chip_smoke.BATCHED_CASES}
    for name in FLAT_CASES[:5]:
        c = cases[name]
        assert (c["B"], c["H"], c["N"], c["nv"], c["items"], c["inputs"]) == (
            384, 12, 272, 261, 48, "flat") and c["sT"] == name.endswith("pvt")
    assert cases["probe19 kernel pvt"]["inputs"] == "pairgrid"
    assert cases["probe19 kernel pvt"]["items"] == 16
    for name in PROBE12_CASES:
        c = cases[name]
        assert (c["stage"], c["inputs"], c["items"], c["sT"], c["noexp"]) == (
            "split", "packed", 16, "pvt" in name, "noexp" in name)
    assert ("probe18/18b flat (B, N, 768)", (384, 272, 768), "bfloat16") in chip_smoke.FLOOR_SHAPES
    assert (chip_smoke.FLAT_MODEL_BATCH, chip_smoke.FLAT_MODEL_ITEMS) == (384, 48)
    built = {ab.option_set(*o) for o in ab.BUILT}
    for c in chip_smoke.BATCHED_CASES:
        assert chip_smoke.batched_label(c["stage"], c["rope"] in ("scaled", "plain"),
                                        c["inputs"] in ("kt", "fatq_kt"), c["inputs"] == "fatq_kt",
                                        c.get("sT", False), c.get("noexp", False))[8:-1] in built
