"""cbas_tpu_torch.ops.attention_variants against the TPU kernels it ports.

Each plain version (what the wrapper runs on a CPU tensor) is held to its
probe body: ``dma_kernel``, ``qk_kernel``, ``nosm_kernel`` and
``pipe_kernel`` of ``benchmarks/attn_probes/probe2.py`` and ``vext_kernel``
of ``probe4.py`` (``bf16exp`` off and on), run through a ``pallas_call`` of
the probes' own block shapes ((gp, N, 128) blocks, (N, 64) tables) in Pallas
interpret mode. The probes build and time their kernels when imported, so the
bodies are taken out of the source with ``ast`` and run with the globals they
read (``d`` 64 and ``scale``).

The bounds, derived here once (u = 2^-8, bf16's unit roundoff):

- RoPE. The probe ropes in bf16 arithmetic: the tables cast to bf16 (q's
  times the scale first), each product and the sum rounded, 3 roundings of
  the terms |x| |cos| + |x_partner| |sin|; the port ropes in fp32 and rounds
  once. So a roped element differs by at most 4u of its terms, and a score
  (q . k over d terms) by delta = 8u (1 + 2^-5) scale (|q| |cos| + ..) .
  (|k| |cos| + ..): both factors' errors, their product and the fp32 sums.
- qk: the two scores differ by delta, then each is rounded: delta plus one
  bf16 ulp.
- nosm: p = bf16(s) differs by delta plus one ulp; p . V over N keys in fp32
  on both sides (N 2^-23 of sum |p| |v|); then one ulp.
- pipe, vext, vext_bf16exp: weights w_j (a softmax) moved by factors within
  e^(+-a_j) move a weighted mean of v by at most 2 max|v| E / (1 - A), E =
  sum w_j expm1(a_j), A = sum w_j a_j. a_j: delta for pipe (plus 2u max|v|
  for p rounded before p.V on each side, against an unrounded row sum);
  delta + 2u/(1-u) for vext (both sums of the rounded p); for vext_bf16exp
  also u (|s_j - m| + |s'_j - m'|) for the bf16 argument of the exponential
  on each side (the probe rounds s - m, the port (s - m) log2(e)), where the
  probe's |s' - m'| is at most |s - m| + 2 delta. Then N 2^-23 max|v| for the
  fp32 sums and one bf16 ulp of the output.

``dma`` is bit for bit. qk and nosm are held at ``n_valid = N`` (the probe
masks nothing there); pipe and the vext forms at ``n_valid < N`` with NaN in
the dead rows of k and v. The packed layout (the probes' own) for every body,
and the flat and head-major layouts through the wrapper's layout handling.

The ``cuda`` tests hold the kernels against their yardsticks on the card and
skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_variants.py
"""

import ast
import functools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu_torch.models.vit import PRESETS
from cbas_tpu_torch.ops import attention_variants as av
from cbas_tpu_torch.ops import flash_attention as fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = os.path.join(ROOT, "benchmarks", "attn_probes")
BODIES = {"dma": ("probe2.py", "dma_kernel", {}), "qk": ("probe2.py", "qk_kernel", {}),
          "nosm": ("probe2.py", "nosm_kernel", {}), "pipe": ("probe2.py", "pipe_kernel", {"nv": 1}),
          "vext": ("probe4.py", "vext_kernel", {"nv": 1, "bf16exp": False}),
          "vext_bf16exp": ("probe4.py", "vext_kernel", {"nv": 1, "bf16exp": True})}
B, G, N, D_HEAD, GP = 2, 2, 72, 64, 2  # BG 4 pairs of 72 rows, 2 pairs a block
NV_DEAD = 67  # pipe and the vext forms: 5 dead rows of k and v, holding NaN
SCALE = D_HEAD ** -0.5
U = 2.0 ** -8  # bf16's unit roundoff


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The TPU probes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _probe_body(file, name):
    """The probe's body ``name`` out of its source, with the globals it reads."""
    from jax.experimental import pallas as pl

    path = os.path.join(PROBES, file)
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {"jax": jax, "jnp": jnp, "pl": pl, "d": D_HEAD, "scale": SCALE}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), namespace)
    return namespace[name]


def _inputs(nv):
    """Packed (B, G, N, 128) q, k, v as the probes make them (standard normal
    x 0.3), as float32 numpy exactly representable in bf16, NaN in k's and
    v's rows at or past ``nv``; standard normal (N, 64) tables."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, G, N, 2 * D_HEAD), np.float32) * 0.3)
               .to(torch.bfloat16).float().numpy() for _ in range(3))
    k[:, :, nv:] = np.nan
    v[:, :, nv:] = np.nan
    cos, sin = (rng.standard_normal((N, D_HEAD)).astype(np.float32) for _ in range(2))
    return q, k, v, cos, sin


@functools.lru_cache(maxsize=None)
def _probe_out(variant):
    """The probe body of ``variant`` on :func:`_inputs`, in interpret mode,
    as packed (B, G, N, 128) float64."""
    from jax.experimental import pallas as pl

    file, name, extra = BODIES[variant]
    nv = NV_DEAD if extra.get("nv") else N
    kw = {"gp": GP} | ({"n_valid": nv} if "nv" in extra else {}) | (
        {"bf16exp": extra["bf16exp"]} if "bf16exp" in extra else {})
    body = functools.partial(_probe_body(file, name), **kw)
    blocks = pl.BlockSpec((GP, N, 2 * D_HEAD), lambda b, i: (b, i, 0))
    keys = pl.BlockSpec((GP, N, 2 * D_HEAD), lambda b, i: (b, 0, 0))
    tables = pl.BlockSpec((N, D_HEAD), lambda b, i: (i, 0))
    call = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((B * G, N, 2 * D_HEAD), jnp.bfloat16),
                          grid=(B * G // GP, 1), in_specs=[blocks, keys, keys] + [tables] * 4,
                          out_specs=blocks, interpret=True)
    q, k, v, cos, sin = _inputs(nv)
    flat = [jnp.asarray(t.reshape(B * G, N, 2 * D_HEAD), jnp.bfloat16) for t in (q, k, v)]
    out = call(*flat, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(cos), jnp.asarray(sin))
    return np.asarray(out.astype(jnp.float32), np.float64).reshape(B, G, N, 2 * D_HEAD)


def _heads(t):
    """Packed (B, G, N, 128) numpy as head-major (B, 2G, N, 64)."""
    return t.reshape(B, G, N, 2, D_HEAD).transpose(0, 1, 3, 2, 4).reshape(B, 2 * G, N, D_HEAD)


def _ulp(x):
    """One bf16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _bound(variant, q, k, v, cos, sin, nv, want):
    """The module docstring's bound on |port - probe|, head-major float64."""
    qh, kh, vh = (_heads(t).astype(np.float64) for t in (q, k, v))
    live = np.arange(N) < nv
    kh[:, :, ~live], vh[:, :, ~live] = 0.0, 0.0

    def terms(t):  # |x| |cos| + |x_partner| |sin|
        a = np.abs(t)
        partner = np.concatenate([a[..., D_HEAD // 2:], a[..., :D_HEAD // 2]], -1)
        return a * np.abs(cos) + partner * np.abs(sin)

    delta = 8 * U * (1 + 2.0 ** -5) * SCALE * (terms(qh) @ terms(kh).swapaxes(-1, -2))
    tq, tk, tv = (torch.from_numpy(_heads(t)).to(torch.bfloat16) for t in (q, k, v))
    _, _, _, s = av.roped_scores(tq, tk, tv, SCALE, nv, torch.from_numpy(cos),
                                 torch.from_numpy(sin), torch.bfloat16)
    s = s.double().numpy()
    want = np.abs(want)
    if variant == "qk":
        tol = delta[..., :D_HEAD]
        return tol + _ulp(want + tol)
    if variant == "nosm":
        p = np.abs(torch.from_numpy(s).to(torch.bfloat16).double().numpy())
        tol = (delta + _ulp(np.abs(s) + delta)) @ np.abs(vh) + N * 2.0 ** -23 * (p @ np.abs(vh))
        return tol + _ulp(want + tol)
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    w = np.exp(s - m)
    w /= w.sum(-1, keepdims=True)
    d_row = np.where(live, delta, 0.0).max(-1, keepdims=True)
    a = np.where(live, delta, 0.0)
    if variant == "vext":
        a = a + 2 * U / (1 - U)
    elif variant == "vext_bf16exp":
        a = a + 2 * U / (1 - U) + U * np.where(live, 2 * np.abs(s - m) + 2 * d_row, 0.0)
    e = (w * np.expm1(a)).sum(-1, keepdims=True)
    vmax = np.abs(vh).max(axis=(-2, -1), keepdims=True)
    tol = 2 * vmax * e / (1 - (w * a).sum(-1, keepdims=True)) + N * 2.0 ** -23 * vmax
    if variant == "pipe":
        tol = tol + 2 * U * vmax
    return tol + _ulp(want + tol)


def _port(variant, layout, q, k, v, cos, sin, nv, fused=False):
    """The wrapper on the CPU with the packed numpy inputs put in ``layout``
    (``fused``: flat views of one (B, N, 3D) buffer); its output back as
    packed float64."""
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    if layout == "fat" and fused:
        buf = torch.cat([av.from_heads(av.to_heads(t, "packed"), "fat") for t in (tq, tk, tv)], -1)
        tq, tk, tv = (buf[..., j * G * 128:(j + 1) * G * 128] for j in range(3))
    elif layout != "packed":
        tq, tk, tv = (av.from_heads(av.to_heads(t, "packed"), layout) for t in (tq, tk, tv))
    got = av.attention_variant(tq, tk, tv, SCALE, nv if nv < N else None, torch.from_numpy(cos),
                               torch.from_numpy(sin), variant=variant, layout=layout)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert got.stride() == fa._dense_like(tq).stride()
    return av.from_heads(av.to_heads(got, layout), "packed").double().numpy()


CASES = [(variant, "packed", False) for variant in av.VARIANTS] + [
    ("nosm", "fat", True), ("vext_bf16exp", "fat", False), ("qk", "headmajor", False),
    ("pipe", "headmajor", False)]


@pytest.mark.parametrize("variant,layout,fused", CASES)
def test_plain_version_matches_the_probe_body(variant, layout, fused):
    """Each plain version against its probe body (interpret mode), within
    the module docstring's bound; dma bit for bit."""
    nv = NV_DEAD if BODIES[variant][2].get("nv") else N
    q, k, v, cos, sin = _inputs(nv)
    got = _port(variant, layout, q, k, v, cos, sin, nv, fused)
    want = _probe_out(variant)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if variant == "dma":
        assert np.array_equal(got, want) and np.array_equal(got, q)
        return
    tol = _bound(variant, q, k, v, cos, sin, nv, _heads(want))
    err = np.abs(_heads(got) - _heads(want))
    assert (err <= tol).all(), float((err / tol).max())
    assert err.max() > 0  # the two round RoPE at different points


def test_qk_and_nosm_read_dead_keys_as_zero_rows():
    """Below ``n_valid = N`` the kernel's maps end K and V at ``n_valid``:
    the plain qk's columns of dead keys are 0, and nosm equals its value with
    those rows zeroed, whatever the dead rows hold (NaN here)."""
    q, k, v, cos, sin = _inputs(NV_DEAD)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    tabs = (torch.from_numpy(cos), torch.from_numpy(sin))
    kz, vz = tk.clone(), tv.clone()
    kz[:, :, NV_DEAD:], vz[:, :, NV_DEAD:] = 0, 0
    for variant in ("qk", "nosm"):
        got = av.attention_variant(tq, tk, tv, SCALE, NV_DEAD, *tabs, variant=variant,
                                   layout="packed")
        zeroed = av.attention_variant(tq, kz, vz, SCALE, None, *tabs, variant=variant,
                                      layout="packed")
        assert torch.isfinite(got).all() and torch.equal(got, zeroed)
    cols = av.to_heads(av.attention_variant(tq, tk, tv, SCALE, 10, *tabs, variant="qk",
                                            layout="packed"), "packed")
    assert (cols[..., 10:] == 0).all() and (cols[..., :10] != 0).all()


@pytest.mark.parametrize("layout,d", [("fat", 64), ("packed", 64), ("headmajor", 64),
                                      ("headmajor", 128)])
def test_pipe_is_variant_zero_bit_for_bit(layout, d):
    """pipe's plain version is K1's, K2's or K3's own plain version (the
    kernel is held to variant 0 bit for bit on the card)."""
    cfg = PRESETS["dinov3-vitb16"]
    H = 4 if d == 64 else 2
    case = ("cut", layout, 2, 21, H, d, 19, None if layout == "packed" else (4, 4))
    q, k, v, cos, sin = chip_smoke.stage_inputs(torch, cfg, case, "cpu")
    default = {"fat": fa.fused_attention_fat, "packed": fa.fused_attention_packed,
               "headmajor": fa.fused_attention}[layout]
    got = av.attention_variant(q, k, v, d ** -0.5, 19, cos, sin, variant="pipe", layout=layout)
    assert torch.equal(got, default(q, k, v, d ** -0.5, 19, cos, sin))


def _register_cap(threads, blocks):
    """The registers a thread may hold with ``blocks`` blocks of
    ``threads`` resident on an SM: its 65536 lie in 4 sub-partitions, each
    holding a quarter of the warps (rounded up), in steps of 8, at most
    255."""
    warps = -(-blocks * (threads // 32) // 4)
    return min(255, 16384 // (32 * warps) // 8 * 8)


@pytest.mark.parametrize("d", [64, 128])
def test_launch_config_gives_the_pipe_loop_its_own_budget(d):
    """Every build runs a consumer warpgroup and a producer warp. Variant 0
    and every variant but the pipe loop's take the body's launch: 2 stages,
    4 blocks an SM at 64 and 3 at 128 (register caps 96 and 128). The pipe
    loop takes a ring of 4 stages at the most blocks an SM whose cap holds
    what ptxas took for it on the card without spills (141 registers at 64,
    178 at 128): 2 at 64, 1 at 128; their shared memory fits an SM."""
    for variant in ("full",) + av.VARIANTS:
        want = av.PIPE_LAUNCH[d] if variant == "pipe" else av.BODY_LAUNCH[d]
        assert av.launch_config(variant, d) == want
    body = av.launch_config("full", d)
    assert body == {"threads": 160, "stages": 2, "min_blocks": 4 if d == 64 else 3}
    assert _register_cap(160, body["min_blocks"]) == {64: 96, 128: 128}[d]
    pipe = av.launch_config("pipe", d)
    assert pipe == {"threads": 160, "stages": 4, "min_blocks": 2 if d == 64 else 1}
    took = {64: 141, 128: 178}[d]
    assert _register_cap(160, pipe["min_blocks"] + 1) < took <= _register_cap(
        160, pipe["min_blocks"])
    tile = 64 * d * 2  # one K or V tile (bf16), and Q's
    assert pipe["min_blocks"] * (1024 + tile + pipe["stages"] * tile + 72) <= 232448
    with pytest.raises(ValueError, match="no variant"):
        av.launch_config("pipe", 96)


def test_no_route_runs_the_pipe_loop():
    """The pipe loop's route table is empty: it met the 0.98x rule at no
    width (PERF.md §6), so K1-K3's entries and the host launch they call
    (``sm90::launch``) name no variant but variant 0, at every key-tile
    count, and only the variants' entry builds the pipe loop; K1-K3's
    plain versions are pipe's (``test_pipe_is_variant_zero_bit_for_bit``)."""
    csrc = os.path.join(ROOT, "cbas_tpu_torch", "csrc")
    for name in ("attention_fat.cu", "attention_packed.cu", "attention_headmajor.cu"):
        with open(os.path.join(csrc, name)) as f:
            assert "kPipe" not in f.read(), name
    with open(os.path.join(csrc, "attention_sm90.cuh")) as f:
        body = f.read()
    launch = body[body.index("cudaError_t launch("):body.index("cudaError_t launch_staged(")]
    assert "kPipe" not in launch and "n_tiles" not in launch
    with open(os.path.join(csrc, "attention_variants.cu")) as f:
        assert "CBAS_VARIANT(kPipe)" in f.read()


def test_qk_at_head_dim_128_is_the_first_128_keys_scores():
    """At d 128 (K3) the qk output's columns are the scores of keys 0..127,
    zero past N."""
    rng = np.random.default_rng(5)
    for n in (150, 100):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, n, 128), np.float32))
                   .to(torch.bfloat16) for _ in range(3))
        got = av.attention_variant(q, k, v, 0.1, None, variant="qk", layout="headmajor")
        s = ((q.float() * 0.1).to(torch.bfloat16).float() @ k.float().transpose(-1, -2))
        want = torch.nn.functional.pad(s[..., :128], (0, max(0, 128 - n))).to(torch.bfloat16)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# chip_smoke.py's bounds against an emulation of the kernel's online loop
# ---------------------------------------------------------------------------

def _emulated_kernel(q, k, v, scale, nv, cos, sin, variant, fault=None):
    """The row-sum variants' loop as the kernel runs it, on head-major
    tensors, but in its own summation orders: the scores summed in float64
    and rounded once (the tensor cores sum in another order than the plain
    matmul), x = s log2(e) - m log2(e) as one fused multiply-add, the
    exponentials, p.V and p.1 in float64, then acc (1 / lsum). vext_bf16exp's
    exponential is the correctly rounded 2^bf16(x). ``fault`` plants one
    mistake: "fp32_exp" (vext_bf16exp without the bf16 argument: vext's
    exponential), "no_log2e" (p = 2^(s - m)), "no_lsum_rescale" (the row sum
    not rescaled by alpha), "swapped_pairs" (the two keys of each bf16x2 pair
    of p swapped)."""
    qh, kh, vh, _ = av.roped_scores(q, k, v, scale, nv, cos, sin, torch.bfloat16)
    s = (qh.double() @ kh.double().transpose(-1, -2)).float()
    log2e = torch.tensor(av.LOG2E, dtype=torch.float32)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],), dtype=torch.float64)
    lsum = torch.zeros(s.shape[:-1] + (1,), dtype=torch.float64)
    for k0 in range(0, nv, 64):
        st = s[..., k0:min(k0 + 64, nv)]
        mx = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(((m - mx) * log2e).double())
        if fault == "no_log2e":
            x = (st.double() - mx.double()).float()
        else:
            x = (st.double() * float(log2e) - (mx * log2e).double()).float()
        if variant == "vext_bf16exp" and fault != "fp32_exp":
            p = av.ex2_bf16(x.to(torch.bfloat16)).double()
        else:
            p = torch.exp2(x.double()).float().to(torch.bfloat16).double()
        if fault == "swapped_pairs":
            even = p.shape[-1] // 2 * 2
            p[..., :even] = p[..., :even].unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
        acc = acc * alpha + p @ vh[..., k0:k0 + p.shape[-1], :].double()
        lsum = (lsum if fault == "no_lsum_rescale" else lsum * alpha) + p.sum(-1, keepdim=True)
        m = mx
    return (acc * (1.0 / lsum)).float().to(torch.bfloat16)


# The main paths' shapes at a cut batch (stage_inputs' cases): K1's at
# dinov3-vitb16's 256x256 on fused views, the probes' packed 640x480 blocks
# (inputs x 0.3, 1205 live rows; two head pairs), K3's at the ViT-7B width.
BOUND_CASES = {"K1 256x256": ("fat", 1, 261, 12, 64, 261, (16, 16)),
               "probe blocks": ("packed", 1, 1216, 4, 64, 1205, None),
               "K3 d 128": ("headmajor", 1, 261, 4, 128, 261, (16, 16))}


@functools.lru_cache(maxsize=None)
def _bound_case(name, variant):
    """A BOUND_CASES case with RoPE: head-major (q, k, v, scale, nv, cos, sin), the
    plain version's output and chip_smoke's bound on the kernel's."""
    layout, b, n, h, d, nv, grid = BOUND_CASES[name]
    q, k, v, cos, sin = chip_smoke.stage_inputs(torch, PRESETS["dinov3-vitb16"],
                                                (name, layout, b, n, h, d, nv, grid), "cpu")
    q, k, v = (av.to_heads(t, layout) for t in (q, k, v))
    scale, n_valid = d ** -0.5, nv if nv < n else None
    want = av.attention_variant_reference(q, k, v, scale, n_valid, cos, sin, variant=variant,
                                          layout="headmajor")
    tol = chip_smoke.stage_tolerance(torch, av, variant, "headmajor", q, k, v, scale, nv, cos,
                                     sin, want)
    return (q, k, v, scale, nv, cos, sin), want, tol


@pytest.mark.parametrize("variant", ["vext", "vext_bf16exp"])
@pytest.mark.parametrize("case", list(BOUND_CASES))
def test_stage_tolerance_covers_the_online_loop(variant, case):
    """chip_smoke's card bound for the vext forms holds between the plain
    version and the kernel's loop emulated in other summation orders, at the
    main paths' shapes; the bound is a few of the output's ulps."""
    args, want, tol = _bound_case(case, variant)
    got = _emulated_kernel(*args, variant)
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all() and (err <= tol).all(), float((err / tol).max())
    assert err.max() > 0
    ulp = chip_smoke.dtype_ulp(torch, want.float())
    assert float((tol / ulp).median()) < 8  # 2.3-4.5 here


FAULTS = [("vext_bf16exp", "fp32_exp")] + [
    (variant, fault) for variant in ("vext", "vext_bf16exp")
    for fault in ("no_log2e", "no_lsum_rescale", "swapped_pairs")]


@pytest.mark.parametrize("variant,fault", FAULTS)
@pytest.mark.parametrize("case", list(BOUND_CASES))
def test_stage_tolerance_catches_a_planted_fault(variant, fault, case):
    """A kernel with one planted mistake leaves chip_smoke's bound at the
    main paths' shapes (the emulated loop of the test above, faulted)."""
    args, want, tol = _bound_case(case, variant)
    got = _emulated_kernel(*args, variant, fault)
    err = (got.float() - want.float()).abs()
    assert (err > tol).any(), float((err / tol).max())


def test_ex2_deviation_reads_where_the_card_leaves_the_rounded_exponential(monkeypatch):
    """chip_smoke.ex2_deviation against a stand-in for the card's table: 0
    where it is the correctly rounded 2^y, |ln(card / plain)| where it is
    not, and a raise past 2^-7 relative; a stage bound widened by it."""
    values = av.bf16_values("cpu")
    monkeypatch.setattr(av, "bf16_values", lambda device: values)
    plain = av.ex2_bf16(values)
    i = int((values == -1.5).nonzero())
    for factor, raises in ((1 + 2.0 ** -8, False), (1 + 2.0 ** -6, True)):
        card = plain.clone()
        card[i] *= factor
        monkeypatch.setattr(av, "ex2_bf16_on_card", lambda device, card=card: card)
        if raises:
            with pytest.raises(AssertionError, match="leaves 2"):
                chip_smoke.ex2_deviation(torch, av)
            continue
        dev, report = chip_smoke.ex2_deviation(torch, av)
        assert report["differ_from_correctly_rounded"] == 1
        assert torch.equal(dev.nonzero().flatten(), torch.tensor([i]))
        assert math.isclose(float(dev[i]), math.log(factor), rel_tol=1e-4)  # card in fp32
    (q, k, v, scale, nv, cos, sin), want, tol = _bound_case("K1 256x256", "vext_bf16exp")
    wider = chip_smoke.stage_tolerance(torch, av, "vext_bf16exp", "headmajor", q, k, v, scale, nv,
                                       cos, sin, want, torch.full((2 ** 16,), 2.0 ** -8))
    assert (wider >= tol).all() and (wider > tol).any()


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,match", [
    ("float32", "built for bfloat16"),
    ("head dim 96", "built at head dims"),
    ("head dim 32", "built at head dims"),
    ("packed last dim 64", "expected packed"),
    ("flat width 100", "expected flat"),
    ("overlapping rows", "overlaps"),
    ("misaligned base", "k starts at"),
    ("different strides", "must share strides"),
    ("unknown variant", "variant must be one of"),
    ("unknown layout", "layout must be one of"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(case, match):
    """On the CPU as on the card: the refusals come before the plain version."""
    t = torch.zeros(2, 4, 16, 64, dtype=torch.bfloat16)
    q = k = v = t
    kw = {"variant": "qk", "layout": "headmajor"}
    if case == "float32":
        q = k = v = t.float()
    elif case in ("head dim 96", "head dim 32"):
        q = k = v = torch.zeros(2, 4, 16, int(case.split()[-1]), dtype=torch.bfloat16)
    elif case == "packed last dim 64":
        kw["layout"] = "packed"
    elif case == "flat width 100":
        q = k = v = torch.zeros(2, 16, 100, dtype=torch.bfloat16)
        kw["layout"] = "fat"
    elif case == "overlapping rows":
        base = torch.zeros(4096, dtype=torch.bfloat16)
        q = k = v = torch.as_strided(base, (2, 16, 128), (16 * 64, 64, 1))
        kw["layout"] = "fat"
    elif case == "misaligned base":
        base = torch.zeros(t.numel() + 8, dtype=torch.bfloat16)
        k = base[1:1 + t.numel()].view(t.shape)
    elif case == "different strides":
        k = torch.zeros(2, 4, 16, 128, dtype=torch.bfloat16)[..., :64]
    elif case == "unknown variant":
        kw["variant"] = "full"
    elif case == "unknown layout":
        kw["layout"] = "flat"
    with pytest.raises(ValueError, match=match):
        av.attention_variant(q, k, v, 1.0, **kw)


def test_kernel_path_refuses_a_cpu_tensor():
    """The kernel path never runs the plain version: a CPU tensor there raises."""
    t = torch.zeros(1, 16, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        av._launch("qk", "fat", t, t, t, 1.0, 16, None, None, 1, 16, 2, 64)


def test_launches_count_kernel_launches_only(monkeypatch):
    """CPU calls never count; each kernel launch counts once, by variant."""
    monkeypatch.setattr(av, "launches", 0)
    monkeypatch.setattr(av, "launches_by_variant", {})
    t = torch.zeros(1, 16, 128, dtype=torch.bfloat16)
    for variant in av.VARIANTS:
        av.attention_variant(t, t, t, 1.0, variant=variant, layout="fat")
    assert av.launches == 0 and av.launches_by_variant == {}
    av._count_launch("qk")
    av._count_launch("qk")
    av._count_launch("dma")
    assert av.launches == 3 and av.launches_by_variant == {"qk": 2, "dma": 1}


# ---------------------------------------------------------------------------
# chip_smoke.py's stage phase and the ptxas reports
# ---------------------------------------------------------------------------

def test_chip_smoke_stage_phase_runs_on_cpu(monkeypatch):
    """The stage phase at a cut size, the plain versions on both sides: every
    check holds (pipe bit for bit the default body's plain version), NaN in
    the dead rows, and nothing is counted."""
    cases = (("probe blocks, cut", "packed", 2, 72, 4, 64, 67, None),
             ("K1, cut", "fat", 2, 21, 4, 64, 21, (4, 4)),
             ("K3 d 128, cut", "headmajor", 1, 150, 2, 128, 140, (12, 12)))
    monkeypatch.setattr(chip_smoke, "STAGE_CASES", cases)
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    out = chip_smoke.stage_phase(torch, PRESETS["dinov3-vitb16"], device="cpu")
    assert out["launches"] == {} and len(out["cases"]) == 2 * len(cases)
    for c in out["cases"]:
        assert c["ok"] and set(c["variants"]) == set(av.VARIANTS)
        assert c["variants"]["pipe"]["tol"] == "bit-equal to variant 0"


def test_stage_cases_are_the_probes_and_the_main_paths_shapes():
    """The probes' (320 * 6, 1216, 128) blocks with 1205 live rows first,
    then the main paths' fused-view shapes: K1's and K3's."""
    probe = chip_smoke.STAGE_CASES[0]
    assert probe[1:] == ("packed", 320, 1216, 12, 64, 1205, None)
    main = {(c[2], c[3], c[4], c[5]) for c in chip_smoke.STAGE_CASES[1:]}
    assert main == set(chip_smoke.FUSED_SHAPES + chip_smoke.FUSED_SHAPES_7B)
    assert {c[1] for c in chip_smoke.STAGE_CASES[1:]} == {"fat", "headmajor"}
    index, headline = chip_smoke.STAGE_HEADLINE
    assert headline in av.VARIANTS and chip_smoke.STAGE_CASES[index][-1] is not None


def test_ptxas_reports_name_the_variants_and_keep_variant_zero_comparable():
    """chip_smoke names a variant's kernel by its variant, and reads variant 0
    under the name a checkout without variants gives it (chip_ab's
    comparison of two checkouts)."""
    mangled = ("_ZN13cbas_attention4sm9014attention_sm90ILi64ELi4ELi{}EEEv14CUtensorMap_stS2_S2_S2_"
               "PKfS4_iifNS0_10MapAddressE")
    log = "".join(
        f"ptxas info    : Compiling entry function '{mangled.format(v)}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {8 * v} bytes spill stores, {8 * v} bytes spill loads\n"
        f"ptxas info    : Used {90 + v} registers, used 1 barriers, 400 bytes cmem[0]\n"
        for v in (0, 4))
    assert chip_smoke.ptxas_report(log) == ["sm90<64, 4>: 90 regs, 0/0 spill",
                                            "sm90<64, 4, pipe>: 94 regs, 32/32 spill"]
    entries = chip_smoke.ptxas_entries(log)
    assert chip_smoke.comparable_name(mangled.format(0)) == mangled.replace("ELi{}E", "E")
    assert chip_smoke.comparable_name(mangled.format(4)) == mangled.format(4)
    assert entries[mangled.format(0)] == {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 90, "smem": 0,
        "wgmma_serialized": False}
    note = ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
            f"are serialized due to insufficient register resources for the function "
            f"'{mangled.format(4)}'\n")
    assert chip_smoke.ptxas_report(note + log)[1].endswith("32/32 spill, wgmma serialized")
    assert chip_smoke.ptxas_entries(note + log)[mangled.format(4)]["wgmma_serialized"]
    anonymous = "_ZN45_GLOBAL__N__{}_12_layernorm_cu_{}11add_ln_rowsIfLi1ELi8EEEvNS_4ArgsEi"
    names = {chip_smoke.comparable_name(anonymous.format(a, b))
             for a, b in (("cfcbea0c", "613515e7"), ("0123abcd", "89abcdef"))}
    assert len(names) == 1  # the hashes of the file's path are dropped
    assert chip_smoke.kernel_label("_ZN54_GLOBAL__N__dfeb3fb8_21_attention_variants_cu_6aeb13b0"
                                   "16ex2_bf16x2_tableEPj") == "ex2_bf16x2_table"


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_CASES = [("packed", 2, 272, 12, 64, 261, None), ("fat", 2, 261, 12, 64, 261, (16, 16)),
              ("fat", 2, 272, 12, 64, 261, (16, 16)), ("headmajor", 2, 261, 8, 128, 261, (16, 16)),
              ("headmajor", 1, 329, 8, 128, 300, (18, 18)), ("headmajor", 2, 100, 4, 64, 90, (8, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("layout,b,n,h,d,nv,grid", CARD_CASES)
def test_each_variant_holds_its_yardstick_on_card(layout, b, n, h, d, nv, grid, rope,
                                                   cuda_device):
    """Every variant's kernel against its yardstick (chip_smoke.stage_check:
    dma bit for bit q, pipe bit for bit variant 0, the rest their plain
    versions within stage_tolerance), one launch a call."""
    case = ("card", layout, b, n, h, d, nv, grid)
    q, k, v, cos, sin = chip_smoke.stage_inputs(torch, PRESETS["dinov3-vitb16"], case,
                                                cuda_device)
    if not rope:
        cos = sin = None
    default = {"fat": fa.fused_attention_fat, "packed": fa.fused_attention_packed,
               "headmajor": fa.fused_attention}[layout]
    n_valid = nv if nv < n else None
    full = default(q, k, v, d ** -0.5, n_valid, cos, sin)
    ex2_dev = chip_smoke.ex2_deviation(torch, av)[0]
    for variant in av.VARIANTS:
        before = av.launches
        got = av.attention_variant(q, k, v, d ** -0.5, n_valid, cos, sin, variant=variant,
                                   layout=layout)
        assert av.launches == before + 1
        assert got.stride() == fa._dense_like(q).stride()
        check = chip_smoke.stage_check(torch, av, variant, layout, q, k, v, d ** -0.5, nv, cos,
                                       sin, got, full, ex2_dev)
        assert check["ok"], (variant, check)
