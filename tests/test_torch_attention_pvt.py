"""cbas_tpu_torch.ops.attention_pvt against the TPU kernels it ports.

The plain version (what ``attention_pvt`` runs on a CPU tensor) is held to
each transposed-score probe body, run through the probe's own ``pallas_call``
in Pallas interpret mode (its ``make_variant`` or ``make_fat_kernel`` and the
body taken out of the source with ``ast``, ``pl.pallas_call`` bound to
``interpret=True``):

- probe3's ``pvt_kernel`` (form std), probe6's (the same body, std);
- probe5's ``pvt_kernel`` at every ``bf16exp x vext`` (forms rounded and
  vext, with and without the bf16 exponential);
- probe4's ``pvt_vext_kernel`` at bf16exp off and on (form vext);
- probe23's ``make_fat_kernel`` at ``unroll`` True and False on flat (B, N,
  4 x 64) tensors, with the model's tables (cbas_tpu's ``_full_rope_tables``
  times the scale).

The size is ``test_torch_attention_batched``'s (2 images of 2 head pairs, N
72 with 67 live keys, NaN in the dead k and v rows, standard normal x 0.3
inputs and standard normal tables, two pairs a program), and one image of one
pair at the probes' N 1216 with 1205 live keys (one pair a program), whose
row is 19 key tiles with a partial last one.

The bound is ``chip_smoke.pvt_tolerance``, the card's bound for the kernel
(its derivation in its docstring), with one term added here: XLA may keep
RoPE's bf16 products in fp32 and round once where the port rounds each
(``test_torch_attention_batched``'s RoPE term; u = 2^-8):
3u(1+u) (T_q . |k'| + |q'| . T_k + 3u(1+u) T_q . T_k) a score, T = |x||cos|
+ |rot(x)||sin|. It also holds the plain version against the kernel's
arithmetic emulated in its own orders (the scores rounded once from float64,
the exponential as 2^(s log2(e) - m log2(e)) by one fused multiply-add, the
column sums within a thread across the key tiles, across the eight row groups
in a butterfly and over the four warps in pairs, vext's sum as P.1 in
float64), and planted faults leave it: the partial tile's dead keys left
unmasked, a one-pass stream (a running column max with no rescale of the
earlier tiles' sums and products), and the scale left out of q's tables.

The ``cuda`` tests hold each built option set's kernel against its plain
version on the card, on head-pair and flat views, at N 72 and 1216, and skip
without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_pvt.py
"""

import dataclasses
import functools
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
import test_torch_attention_batched as tb
import test_torch_attention_fat as tf
from cbas_tpu_torch.models.vit import PRESETS
from cbas_tpu_torch.ops import attention_batched as ab
from cbas_tpu_torch.ops import attention_pvt as ap
from cbas_tpu_torch.ops import attention_variants as av
from cbas_tpu_torch.ops import flash_attention as fa

D_HEAD = 64
SCALE = D_HEAD ** -0.5
LOG2E = 1.4426950408889634
U = 2.0 ** -8
# (images, heads, N, live keys, head pairs a program)
SMALL = (tb.B, tb.H, tb.N, tb.NV, 2)
BIG = (1, 2, 1216, 1205, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _inputs(size):
    """Flat (B, N, H*64) q, k, v as float32 numpy exactly representable in
    bf16 (standard normal x 0.3), NaN in k's and v's dead rows; standard
    normal (N, 64) tables. The small size's are test_torch_attention_batched's."""
    if size == SMALL:
        return tb._inputs()
    B, H, N, nv, _ = size
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, N, H * D_HEAD), np.float32) * 0.3)
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    k[:, nv:] = np.nan
    v[:, nv:] = np.nan
    cos, sin = (rng.standard_normal((N, D_HEAD)).astype(np.float32) for _ in range(2))
    return q, k, v, cos, sin


# ---------------------------------------------------------------------------
# The TPU probes
# ---------------------------------------------------------------------------

def _variant_probe_out(file, body, size, **options):
    """``body`` of ``file`` through the file's make_variant (interpret mode) on
    packed (B*G, N, 128) blocks, gp pairs a program, as head-major (B, H, N,
    64) float64."""
    B, H, N, nv, gp = size
    G = H // 2
    q, k, v, cos, sin = _inputs(size)
    blocks = [tb._bf16(t.reshape(B, N, G, 2 * D_HEAD).transpose(0, 2, 1, 3).reshape(
        B * G, N, 2 * D_HEAD)) for t in (q, k, v)]
    fn = tb._probe_fn(file, body, N=N, NV=nv)
    make = tb._probe_fn(file, "make_variant", pl=tf._interpret_pl(), B=B, G=G, N=N,
                        dd=2 * D_HEAD, q=blocks[0])
    call = make(functools.partial(fn, gp=gp, n_valid=nv, **options), gp, N, N)
    tabs = [jnp.asarray(t) for t in (cos, sin, cos, sin)]
    out = np.asarray(call(*blocks, *tabs).astype(jnp.float32), np.float64)
    return out.reshape(B, G, N, 2, D_HEAD).transpose(0, 1, 3, 2, 4).reshape(B, H, N, D_HEAD)


def _probe23_out(unroll):
    """probe23's make_fat_kernel (interpret mode, one image a program) on flat
    (B, N, 4 x 64) tensors with the model's tables times the scale, as
    head-major float64."""
    B, H, N, nv, _ = SMALL
    q, k, v, _, _ = _inputs(SMALL)
    c, s = (jnp.asarray(t * SCALE, jnp.float32) for t in tb._model_tables())
    make = tb._probe_fn("probe23_fat_480p.py", "make_fat_kernel", pl=tf._interpret_pl())
    out = make(B, N, H * D_HEAD, D_HEAD, nv, 1, unroll)(*(tb._bf16(t) for t in (q, k, v)), c, s)
    return np.asarray(out.astype(jnp.float32), np.float64).reshape(B, N, H, D_HEAD).transpose(
        0, 2, 1, 3)


# (case, size, form, bf16exp): each probe body and the option set that ports it
PROBE_CASES = [
    ("probe3 pvt_kernel", SMALL, "std", False),
    ("probe5 pvt_kernel", SMALL, "rounded", False),
    ("probe5 pvt_kernel bf16exp", SMALL, "rounded", True),
    ("probe5 pvt_kernel vext", SMALL, "vext", False),
    ("probe5 pvt_kernel bf16exp+vext", SMALL, "vext", True),
    ("probe6 pvt_kernel", SMALL, "std", False),
    ("probe4 pvt_vext_kernel", SMALL, "vext", False),
    ("probe4 pvt_vext_kernel bf16exp", SMALL, "vext", True),
    ("probe23 make_fat_kernel unroll", SMALL, "std", False),
    ("probe23 make_fat_kernel fori", SMALL, "std", False),
    ("probe3 pvt_kernel at N 1216", BIG, "std", False),
    ("probe4 pvt_vext_kernel bf16exp at N 1216", BIG, "vext", True),
]


def _probe_out(case, size, bf16exp):
    name = case.split(" at ")[0]
    if name.startswith("probe23"):
        return _probe23_out(name.endswith("unroll"))
    if name.startswith("probe5"):
        return _variant_probe_out("probe5.py", "pvt_kernel", size, bf16exp=bf16exp,
                                  vext="vext" in name)
    if name.startswith("probe4"):
        return _variant_probe_out("probe4.py", "pvt_vext_kernel", size, bf16exp=bf16exp)
    file = "probe3.py" if name.startswith("probe3") else "probe6_pvt_interleaved.py"
    return _variant_probe_out(file, "pvt_kernel", size)


# ---------------------------------------------------------------------------
# The port, on the same inputs
# ---------------------------------------------------------------------------

def _port(size, layout="packed", model_tables=False):
    """(operands in ``layout``, head-major views, tables) of the port's call:
    "packed" (B, G, 2, N, 64) views of contiguous (B, G, N, 128) blocks, as
    the probes' blocks are read; "flat" (B, H, N, 64) views of flat (B, N,
    H*64) tensors, probe23's; the tables rope_tables(cos, sin, scale,
    sqrt(d)) (the model's with ``model_tables``)."""
    B, H, N, _, _ = size
    q, k, v, cos, sin = (torch.from_numpy(t) for t in _inputs(size))
    if model_tables:
        cos, sin = (torch.from_numpy(t) for t in tb._model_tables())
    flat = [t.to(torch.bfloat16) for t in (q, k, v)]
    heads = [t.view(B, N, H, D_HEAD).transpose(1, 2) for t in flat]
    if layout == "packed":
        blocks = [t.view(B, N, H // 2, 2 * D_HEAD).transpose(1, 2).contiguous() for t in flat]
        ops = [t.view(B, H // 2, N, 2, D_HEAD).transpose(2, 3) for t in blocks]
    else:
        ops = heads
    return ops, heads, ab.rope_tables(cos, sin, SCALE, D_HEAD ** 0.5)


def _rope_ds(q, k, tables, nv):
    """The module docstring's RoPE term of a score's bound, dead k rows left out."""
    cq, sq, ck, sk = (t.float() for t in tables)

    def terms(x, c, s):
        x = x.float()
        return x.abs() * c.abs() + fa.rotate_half(x).abs() * s.abs()

    live = (torch.arange(q.shape[-2]) < nv)[:, None]
    tq = terms(q, cq, sq)
    tk = torch.where(live, terms(k, ck, sk), 0.0)
    qa = ab.rope_bf16(q, *tables[:2]).float().abs()
    ka = torch.where(live, ab.rope_bf16(k, *tables[2:]).float().abs(), 0.0)
    r = 3 * U * (1 + U)
    return r * (tq @ ka.transpose(-1, -2) + qa @ tk.transpose(-1, -2)
                + r * tq @ tk.transpose(-1, -2))


@pytest.mark.parametrize("case,size,form,bf16exp", PROBE_CASES,
                         ids=[c[0] for c in PROBE_CASES])
def test_plain_version_matches_the_probe_body(case, size, form, bf16exp):
    """The port (its plain version) against the probe body in interpret mode
    within chip_smoke.pvt_tolerance plus the RoPE term; the output dense in
    q's dim order."""
    B, H, N, nv, gp = size
    flat = case.startswith("probe23")
    ops, heads, tables = _port(size, "flat" if flat else "packed", model_tables=flat)
    got = ap.attention_pvt(*ops, nv, tables, form=form, bf16exp=bf16exp,
                           items=H if flat else 2 * gp)
    assert got.dtype == torch.bfloat16 and got.shape == ops[0].shape
    assert got.stride() == fa._dense_like(ops[0]).stride()
    want = _probe_out(case, size, bf16exp)
    got64 = chip_smoke.pvt_heads(got).double().numpy()
    assert np.isfinite(got64).all() and np.isfinite(want).all()
    plain = ap.attention_pvt_reference(*heads, nv, tables, form=form, bf16exp=bf16exp)
    assert torch.equal(plain, chip_smoke.pvt_heads(got))
    tol = chip_smoke.pvt_tolerance(torch, ap, *heads, nv, tables, plain, form, bf16exp,
                                   _rope_ds(heads[0], heads[1], tables, nv)).double().numpy()
    err = np.abs(got64 - want)
    assert (err <= tol).all(), float((err / tol).max())


def test_probe5s_exp_of_a_bf16_array_is_the_plain_versions():
    """The probes' jnp.exp of a bf16 array on the CPU, at every finite bf16
    input below 89: exp in fp32 of the widened argument, a result below
    2^-126 flushed to 0, rounded to bf16 (ap.probabilities with bf16exp)."""
    y = av.bf16_values("cpu")
    y = y[torch.isfinite(y) & (y < 89)]
    want = np.asarray(jnp.exp(jnp.asarray(y.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = ap.probabilities(y.float(), "rounded", True).numpy()
    assert np.array_equal(got, want)


def test_forms_differ_only_in_their_rounding_points():
    """rounded and vext are one function (their sums' orders apart), std is
    within the bound of both, and the layouts and items give the same bits."""
    ops, heads, tables = _port(SMALL)
    nv = SMALL[3]
    outs = {f: ap.attention_pvt_reference(*heads, nv, tables, form=f) for f in ap.FORMS}
    for f in ("rounded", "vext"):
        tol = chip_smoke.pvt_tolerance(torch, ap, *heads, nv, tables, outs["std"], f, False)
        assert ((outs[f].float() - outs["std"].float()).abs() <= tol).all()
    flat = ap.attention_pvt(*heads, nv, tables, form="vext", bf16exp=True, items=3)
    packed = ap.attention_pvt(*ops, nv, tables, form="vext", bf16exp=True)
    contiguous = ap.attention_pvt(*(t.contiguous() for t in heads), nv, tables, form="vext",
                                  bf16exp=True)
    assert torch.equal(flat, chip_smoke.pvt_heads(packed)) and torch.equal(flat, contiguous)


# ---------------------------------------------------------------------------
# chip_smoke.py's bound against the kernel's arithmetic
# ---------------------------------------------------------------------------

def _emulated(q, k, v, nv, tables, form, bf16exp, fault=None):
    """The kernel's arithmetic on head-major operands, in its own orders: RoPE
    in bf16; s^T = K.Q^T over ceil(nv / 64) key tiles (K and V rows past nv
    read as zero, as the tensor maps fill them), summed in float64 and
    rounded once; keys past nv -> -1e30; the column max; x = s log2(e) - m
    log2(e) (m log2(e) rounded to fp32, one fused multiply-add); p = 2^x in
    fp32 ("std"), rounded to bf16 ("rounded", "vext"), or 2^bf16(x) correctly
    rounded (bf16exp); the column sums in the kernel's order
    (test_torch_attention_fat._kernel_order_column_sum, then the warps as
    (w0 + w1) + (w2 + w3)) or, for vext, the ones row of the live keys . P in
    float64 rounded once; o^T = V^T . bf16(P) in float64 rounded once, over
    the sums. ``fault``: "no_mask" (the partial tile's dead keys neither
    masked nor out of vext's ones row: their zero scores join the max and
    the sums), "one_pass" (a running column max over the tiles with no
    rescale of the earlier tiles' sums and products)."""
    qh, kh = ab.rope_bf16(q, *tables[:2]), ab.rope_bf16(k, *tables[2:])
    n, K = q.shape[-2], 64 * math.ceil(nv / 64)
    keys = torch.arange(K)
    live = keys < nv
    if fault == "no_mask":
        live = keys < K

    def rows(t):
        t = t.double()
        pad = torch.zeros(*t.shape[:-2], max(0, K - n), t.shape[-1], dtype=torch.float64)
        return torch.cat([t, pad], -2)[..., :K, :]

    kz = torch.where((keys < nv)[:, None], rows(kh), 0.0)
    vz = torch.where((keys < nv)[:, None], rows(v), 0.0)
    s = torch.where(live[:, None], (kz @ qh.double().transpose(-1, -2)).float(), ab.MASKED)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)

    def weights(st, m):
        x = (st.double() * float(log2e) - (m * log2e).double()).float()
        if bf16exp:
            return av.ex2_bf16(x.to(torch.bfloat16))
        p = torch.exp2(x.double()).float()
        return p if form == "std" else p.to(torch.bfloat16).float()

    if fault == "one_pass":
        m = torch.full(s.shape[:-2] + (1, s.shape[-1]), -math.inf)
        p = torch.zeros_like(s)
        for k0 in range(0, K, 64):
            m = torch.maximum(m, s[..., k0:k0 + 64, :].amax(-2, keepdim=True))
            p[..., k0:k0 + 64, :] = weights(s[..., k0:k0 + 64, :], m)
    else:
        p = weights(s, s.amax(-2, keepdim=True))
    P = p.to(torch.bfloat16).double()
    if form == "vext":
        l = (live.double()[None, :] @ P).float()
    else:
        per_warp = tf._kernel_order_column_sum(p)
        l = ((per_warp[..., 0, :] + per_warp[..., 1, :])
             + (per_warp[..., 2, :] + per_warp[..., 3, :]))[..., None, :]
    acc = (vz.transpose(-1, -2) @ P).float()
    return (acc / l).transpose(-1, -2).to(torch.bfloat16)


def _bound_args(size):
    ops, heads, tables = _port(size)
    return heads, size[3], tables


@pytest.mark.parametrize("size", [SMALL, BIG], ids=["N 72", "N 1216"])
@pytest.mark.parametrize("option", sorted(ap.BUILT), ids=[ap.option_set(*o) for o in sorted(ap.BUILT)])
def test_pvt_tolerance_covers_the_kernels_arithmetic(option, size):
    """chip_smoke's card bound holds between the plain version and the
    kernel's arithmetic emulated in its own orders, and is a few output ulps
    at the median: 1.1 at N 72 and 4.0 at N 1216 (the two summation orders'
    nv 2^-22 grows with the row), 2.5 and 14.3 with the bf16 exponential
    (its argument rounds at another point than the probes', which moves most
    keys' bf16 p by an ulp)."""
    _, form, bf16exp = option
    (q, k, v), nv, tables = _bound_args(size)
    want = ap.attention_pvt_reference(q, k, v, nv, tables, form=form, bf16exp=bf16exp)
    tol = chip_smoke.pvt_tolerance(torch, ap, q, k, v, nv, tables, want, form, bf16exp)
    got = _emulated(q, k, v, nv, tables, form, bf16exp)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and (err <= tol).all(), float((err / tol).max())
    ulp = chip_smoke.dtype_ulp(torch, want.float())
    assert float((tol / ulp).median()) < (3 if size == SMALL else 5) * (5 if bf16exp else 1)


FAULTS = [("no_mask", "std+rope", SMALL), ("no_mask", "vext+rope+bf16exp", SMALL),
          ("no_mask", "rounded+rope", BIG), ("one_pass", "std+rope", BIG),
          ("one_pass", "vext+rope", BIG), ("no_scale", "std+rope", SMALL),
          ("no_scale", "rounded+rope+bf16exp", BIG)]


@pytest.mark.parametrize("fault,option,size", FAULTS,
                         ids=[f"{f} {o} N {s[2]}" for f, o, s in FAULTS])
def test_pvt_tolerance_catches_a_planted_fault(fault, option, size):
    """A kernel with one planted mistake leaves chip_smoke's bound: the
    partial tile's dead keys unmasked, the one-pass stream, or the scale left
    out of q's tables (the kernel has no other place for it)."""
    _, form, bf16exp = next(o for o in ap.BUILT if ap.option_set(*o) == option)
    (q, k, v), nv, tables = _bound_args(size)
    want = ap.attention_pvt_reference(q, k, v, nv, tables, form=form, bf16exp=bf16exp)
    tol = chip_smoke.pvt_tolerance(torch, ap, q, k, v, nv, tables, want, form, bf16exp)
    if fault == "no_scale":
        tables = tuple((t.float() / SCALE).to(torch.bfloat16) for t in tables[:2]) + tables[2:]
    got = _emulated(q, k, v, nv, tables, form, bf16exp, None if fault == "no_scale" else fault)
    err = (got.float() - want.float()).abs()
    assert (err > tol).any(), float((err / tol).max())


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _tables(n):
    return ab.rope_tables(torch.ones(n, D_HEAD), torch.zeros(n, D_HEAD))


@pytest.mark.parametrize("case,match", [
    ("float32", "built for bfloat16"),
    ("head dim 128", "built at head dim 64"),
    ("n_valid 0", "outside"),
    ("n_valid past N", "outside"),
    ("items 0", "items must be at least 1"),
    ("no tables", "not built for std$"),
    ("std with bf16exp", "not built for std\\+rope\\+bf16exp"),
    ("unknown form", "form must be one of"),
    ("3-dim q", "expected \\(B, H, N, 64\\)"),
    ("k of another shape", "does not match"),
    ("table shape", "each table must be bf16"),
    ("misaligned base", "k starts at"),
    ("strided last dim", "the last dim must have stride 1"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """On the CPU as on the card: the refusals come before the plain version."""
    q = k = v = torch.zeros(2, 4, 16, 64, dtype=torch.bfloat16)
    kw = {"tables": _tables(16)}
    if case == "float32":
        q = k = v = q.float()
    elif case == "head dim 128":
        q = k = v = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)
    elif case == "n_valid 0":
        kw["n_valid"] = 0
    elif case == "n_valid past N":
        kw["n_valid"] = 17
    elif case == "items 0":
        kw["items"] = 0
    elif case == "no tables":
        kw["tables"] = None
    elif case == "std with bf16exp":
        kw["bf16exp"] = True
    elif case == "unknown form":
        kw["form"] = "pv"
    elif case == "3-dim q":
        q = k = v = q[0]
    elif case == "k of another shape":
        k = torch.zeros(2, 4, 17, 64, dtype=torch.bfloat16)
    elif case == "table shape":
        kw["tables"] = _tables(15)
    elif case == "misaligned base":
        base = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
        k = base[1:1 + q.numel()].view(q.shape)
    elif case == "strided last dim":
        v = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match=match):
        ap.attention_pvt(q, k, v, **kw)


def test_kernel_path_refuses_a_cpu_tensor():
    """The kernel path never runs the plain version: a CPU tensor there raises."""
    t = torch.zeros(1, 1, 1, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ap._launch(t, t, t, t, 16, _tables(16), "std", False, 16)


def test_launches_count_kernel_launches_only(monkeypatch):
    """CPU calls never count and return the plain version; each kernel
    launch counts once, by option set; BUILT is the five sets the probes run."""
    monkeypatch.setattr(ap, "launches", 0)
    monkeypatch.setattr(ap, "launches_by_option", {})
    ops, heads, tables = _port(SMALL)
    nv = SMALL[3]
    for form, bf16exp in (("std", False), ("vext", True)):
        got = ap.attention_pvt(*ops, nv, tables, form=form, bf16exp=bf16exp)
        want = ap.attention_pvt_reference(*ops, nv, tables, form=form, bf16exp=bf16exp)
        assert torch.equal(got, want)
    assert ap.launches == 0 and ap.launches_by_option == {}
    for name in ("std+rope", "std+rope", "vext+rope+bf16exp"):
        ap._count_launch(name)
    assert ap.launches == 3 and ap.launches_by_option == {"std+rope": 2, "vext+rope+bf16exp": 1}
    assert sorted(ap.option_set(*o) for o in ap.BUILT) == [
        "rounded+rope", "rounded+rope+bf16exp", "std+rope", "vext+rope", "vext+rope+bf16exp"]


def test_no_encode_route_calls_the_pvt_kernel():
    """The kernel is a timing kernel: no module of the port's models, engine,
    app, mesh or tools names it (chip_smoke.py swaps it into the model)."""
    pkg = os.path.join(tb.ROOT, "cbas_tpu_torch")
    for sub in ("models", "engine", "app", "parallel", "tools"):
        for dirpath, _, files in os.walk(os.path.join(pkg, sub)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(dirpath, f)) as fh:
                        assert "attention_pvt" not in fh.read(), f


# ---------------------------------------------------------------------------
# chip_smoke.py's pvt phase and probe15's chained floor
# ---------------------------------------------------------------------------

def test_pvt_cases_are_the_probes_shapes():
    """The probes' (320, 12, 1216 / 1205) blocks; probe3 at gp 8 and 4,
    probe5's four forms at gp 4 and vext+bf16exp at gp 8, probe4's vext at
    bf16exp off (gp 4) and on (gp 4 and 8); every built set among them; the
    sites are the five pallas_call sites and probe23's models its own."""
    assert chip_smoke.PVT_SHAPE == (320, 12, 1216, 1205)
    got = sorted((c["body"].split(":")[0], c["form"], c["bf16exp"], c["gp"])
                 for c in chip_smoke.PVT_CASES)
    assert got == sorted([
        ("probe3.py", "std", False, 8), ("probe3.py", "std", False, 4),
        ("probe5.py", "rounded", False, 4), ("probe5.py", "rounded", True, 4),
        ("probe5.py", "vext", False, 4), ("probe5.py", "vext", True, 4),
        ("probe5.py", "vext", True, 8), ("probe4.py", "vext", False, 4),
        ("probe4.py", "vext", True, 4), ("probe4.py", "vext", True, 8)])
    assert {(True, c["form"], c["bf16exp"]) for c in chip_smoke.PVT_CASES} == ap.BUILT
    assert chip_smoke.PVT_HEADLINE in {c["what"] for c in chip_smoke.PVT_CASES}
    assert [s.split("/")[-1] for s in chip_smoke.PVT_SITES] == [
        "probe3.py:42", "probe5.py:44", "probe6_pvt_interleaved.py:60", "probe4.py:46",
        "probe23_fat_480p.py:92"]
    assert chip_smoke.PVT_MODELS == (("dinov3-vitb16", 320), ("dinov3-vitl16", 96))
    assert chip_smoke.FLOOR_CHAIN_SHAPE == (384, 6, 272, 128)
    assert (chip_smoke.FLOOR_CHAIN_NV, chip_smoke.FLOOR_CHAIN_K) == (261, 5)


def test_chip_smoke_pvt_phase_runs_on_cpu(monkeypatch):
    """The pvt phase at a cut size, the plain versions on both sides: every
    case's check holds, probe23's model A/B through a cut dinov3 encoder
    agrees with the K1 route, and nothing is counted."""
    monkeypatch.setattr(chip_smoke, "PVT_SHAPE", (2, 4, 72, 67))
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    cfg = dataclasses.replace(PRESETS["dinov3-vitb16"], hidden_size=128, num_heads=2,
                              num_layers=2, intermediate_size=256)
    out = chip_smoke.pvt_phase(torch, models=((cfg, 2),), geometry=(96, 128), device="cpu")
    assert out["launches"] == {} and len(out["cases"]) == len(chip_smoke.PVT_CASES)
    assert all(c["ok"] and c["launches"] == 0 for c in out["cases"])
    (model,) = out["models"]
    assert model["ok"] and model["launches_a_forward"] == 0
    assert model["min_cos_vs_k1"] >= chip_smoke.BATCHED_MODEL_MIN_COS


def test_pvt_attention_swaps_only_inside_the_model_case():
    """chip_smoke's probe23 route leaves vit._attention as it was."""
    from cbas_tpu_torch.models import vit
    from cbas_tpu_torch.models.encoder import FrameEncoder

    before = vit._attention
    cfg = dataclasses.replace(PRESETS["dinov3-vitl16"], hidden_size=128, num_heads=2,
                              num_layers=2, intermediate_size=256)
    enc = FrameEncoder("dinov3-vitl16", cfg=cfg, random_init=True, device="cpu")
    planes = np.random.default_rng(0).integers(0, 256, (2, 64, 64), np.uint8)
    out = chip_smoke.pvt_model_case(torch, enc, planes, 2, device="cpu")
    assert vit._attention is before and out["ok"]


def test_floor_chain_runs_on_cpu(monkeypatch):
    """probe15's chain at a cut size on the CPU: each function's K-fold
    chain equals K eager calls, and the plain sum, K2 and its library
    yardstick (SDPA) change x (the floor passes q through)."""
    monkeypatch.setattr(chip_smoke, "FLOOR_CHAIN_SHAPE", (2, 2, 72, 128))
    monkeypatch.setattr(chip_smoke, "FLOOR_CHAIN_NV", 67)
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    out = chip_smoke.floor_chain(torch, device="cpu")
    assert set(out["fns"]) == {"dma", "prod", "xlaadd", "sdpa"}
    assert all(e["ok"] and e["graph_equals_eager"] for e in out["fns"].values())
    assert all(out["fns"][name]["changes_x"] for name in ("xlaadd", "prod", "sdpa"))
    assert not out["fns"]["dma"]["changes_x"]


def test_chain_feeds_each_call_the_last_output():
    """The chain's data dependence: call i + 1 takes call i's output."""
    seen = []

    def fn(x):
        seen.append(x)
        return x + 1

    x0 = torch.zeros(3)
    out = chip_smoke.chain(fn, x0, 5)
    assert seen[0] is x0 and torch.equal(out, torch.full((3,), 5.0))
    assert all(torch.equal(seen[i], torch.full((3,), float(i))) for i in range(5))


def test_ptxas_labels_name_the_pvt_option_sets():
    """chip_smoke names each instantiation of the pvt kernel by its option set."""
    mangled = ("_ZN53_GLOBAL__N__1d417218_16_attention_pvt_cu_f2d782ef13attention_pvtILi{}"
               "ELb{}EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE")
    assert chip_smoke.kernel_label(mangled.format(0, 0)) == "pvt<std+rope>"
    assert chip_smoke.kernel_label(mangled.format(1, 1)) == "pvt<rounded+rope+bf16exp>"
    assert chip_smoke.kernel_label(mangled.format(2, 1)) == "pvt<vext+rope+bf16exp>"
    assert chip_smoke.kernel_label(
        "_ZN49_GLOBAL__N__8efe298c_16_attention_pvt_cu_25a33d3311rope_k_rowsEPK13__nv_bfloat16"
        "PS0_S2_S2_xxxxiiiix") == "rope_k_rows"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_CASES = [(o, layout, size) for o in sorted(ap.BUILT) for layout in ("packed", "flat")
              for size in (SMALL, BIG)]


@pytest.mark.cuda
@pytest.mark.parametrize("option,layout,size", CARD_CASES,
                         ids=[f"{ap.option_set(*o)} {lay} N {s[2]}" for o, lay, s in CARD_CASES])
def test_kernel_holds_its_plain_version_on_card(option, layout, size, cuda_device):
    """Each built option set's kernel against its plain version
    (chip_smoke.pvt_check, within pvt_tolerance and the card's bf16
    exponential), one launch a call, on head-pair and flat views."""
    _, form, bf16exp = option
    ops, _, tables = _port(size, layout)
    ops = [t.to(cuda_device) for t in ops]
    tables = tuple(t.to(cuda_device) for t in tables)
    before = ap.launches
    got = ap.attention_pvt(*ops, size[3], tables, form=form, bf16exp=bf16exp, items=3)
    torch.cuda.synchronize()
    assert ap.launches == before + 1
    ex2_dev = chip_smoke.ex2_deviation(torch, av)[0] if bf16exp else None
    check = chip_smoke.pvt_check(torch, ap, {"form": form, "bf16exp": bf16exp}, *ops, size[3],
                                 tables, got, ex2_dev)
    assert check["ok"], check
