"""The persistent Hopper body at head dims 64 and 128, a timing case.

``csrc/attention_sm90_persistent.cuh`` computes K1's, K2's and K3's bf16
function at the 64 and 128 builds, bit for bit the one-warpgroup body's:
persistent blocks take work items (one query tile of one image and head)
from a counter and walk them through a ring that spans items, Q
double-buffered and roped by a warp of its own. It measured slower than the
one-warpgroup body at every main shape (PERF.md §6, PR 24), so no route
calls it; ``attention_persistent.persistent_attention`` runs it, and K1-K3's
own wrappers run the one-warpgroup body it is held against.

On the CPU: the routes are as before (bf16 64 and 128 on the one-warpgroup
body, no entry includes the persistent body), the work-item walk's mirrors
(``work_item``, ``persistent_walk``: every query tile of every head and
image exactly once, on a grid smaller and larger than the items, the items
in flight a compact run) and the entry's argument checks. The plain
versions are held against the JAX package elsewhere
(``test_torch_attention*.py``), so none is repeated here.

The ``cuda`` tests hold the body against the plain version and, bit for bit,
against what K1-K3's wrappers launch on the same inputs, and skip without a
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_persistent.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import attention_persistent as ap
from cbas_tpu_torch.ops import flash_attention as fa

BF16 = torch.bfloat16
CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
# (N, n_valid): whole key tiles and not, odd and even query tile counts,
# NaN in the dead rows where n_valid < N.
NS = ((261, None), (272, 261), (329, 300), (1205, None), (1216, 1205))
KERNELS = ("attention_fat", "attention_packed", "attention_headmajor")
# Each layout's plain version and its route's wrapper (the one-warpgroup
# body on the card at 64 and 128).
PLAIN = {"fat": fa.attention_fat_reference, "packed": fa.attention_packed_reference,
         "headmajor": fa.attention_headmajor_reference}
ROUTE = {"fat": fa.fused_attention_fat, "packed": fa.fused_attention_packed,
         "headmajor": fa.fused_attention}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


def test_no_route_calls_the_persistent_body():
    """K1-K3's C entries do not include the persistent body's header, and
    only its own entry (csrc/attention_persistent.cu) does."""
    including = sorted(p.name for p in CSRC.glob("*.cu")
                       if re.search(r'#include "attention_sm90_persistent\.cuh"', p.read_text()))
    assert including == ["attention_persistent.cu"]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_bf16_64_and_128_stay_on_the_one_warpgroup_body(dtype):
    """bf16 at 64 (K1, K2, K3) and at every K3 width up to 192 runs the
    one-warpgroup Hopper body ("sm90"), from 193 to 256 the two-consumer body,
    above it the wide body; fp32 its own bodies: the routes as before."""
    for d in range(1, 301):
        body = fa.attention_body("attention_headmajor", dtype, fa.headmajor_width(dtype, d))
        if dtype == BF16:
            assert body == ("sm90" if d <= 192 else "sm90_ws" if d <= 256 else "wide"), d
        else:
            assert body in fa.TF32_BODIES, d
    for kernel in KERNELS:
        assert fa.attention_body(kernel, dtype, 64) == ("sm90" if dtype == BF16 else "sm90_f32")


@pytest.mark.parametrize("N", [n for n, _ in NS])
def test_work_items_map_one_to_one_onto_query_tiles(N):
    """csrc work_item's mirror: items 0 .. B H T - 1 are every (image, head,
    query tile) once, consecutive items on one head's tiles in order."""
    B, H = 3, 5
    n_qt = -(-N // 64)
    got = [ap.work_item(i, H, N) for i in range(B * H * n_qt)]
    assert got == [(b, h, t) for b in range(B) for h in range(H) for t in range(n_qt)]


@pytest.mark.parametrize("N", [n for n, _ in NS])
@pytest.mark.parametrize("grid", ["smaller", "larger"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_walk_takes_every_item_once(N, grid, seed):
    """However the blocks interleave their fetches from the counter, every
    item is taken exactly once and each block ends on its first fetch past
    the walk, on a grid smaller and larger than the item count (the launch
    takes the smaller of the two: persistent_grid)."""
    B, H = 3, 5
    items = B * H * -(-N // 64)
    resident = 7 if grid == "smaller" else 4 * items
    blocks = ap.persistent_grid(B, N, H, resident)
    assert blocks == min(resident, items)
    walk = ap.persistent_walk(B, N, H, blocks, seed)
    assert sorted(item for _, item in walk) == list(range(items))
    assert {block for block, _ in walk} <= set(range(blocks))


def test_the_items_are_taken_in_counter_order():
    """The k-th fetch from the counter takes item k, whichever block makes
    it: the items in flight are the run from the oldest still held to the
    newest, as the hardware's own block order keeps a grid's blocks (their
    heads' K and V stay in L2)."""
    walk = ap.persistent_walk(32, 1205, 12, 396, seed=3)
    assert [item for _, item in walk] == list(range(len(walk)))
    assert ap.work_item(0, 12, 1205) == (0, 0, 0) and ap.work_item(19, 12, 1205) == (0, 1, 0)


@pytest.mark.parametrize("layout", ap.LAYOUTS)
def test_persistent_attention_on_cpu_is_the_plain_version(layout):
    """On a CPU tensor the entry runs the plain K1, K2 or K3 (with RoPE and
    dead keys), dense in q's dim order."""
    B, N, H, d, nv = 1, 70, 4, 64, 60
    shape = {"fat": (B, N, H * d), "packed": (B, H // 2, N, 2 * d),
             "headmajor": (B, H, N, d)}[layout]
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)
               for _ in range(3))
    ang = rng.standard_normal((N, d)).astype(np.float32)
    cos, sin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    got = ap.persistent_attention(q, k, v, d ** -0.5, nv, cos, sin, layout=layout)
    assert torch.equal(got, PLAIN[layout](q, k, v, d ** -0.5, nv, cos, sin))


def test_persistent_attention_refuses_what_it_does_not_take():
    q = torch.zeros(1, 2, 70, 64, dtype=BF16)
    for kwargs in ({"layout": "flat"}, {"layout": "fat"}, {"layout": "packed"}):
        with pytest.raises(ValueError):
            ap.persistent_attention(q, q, q, 0.125, **kwargs)
    for bad in (torch.zeros(1, 2, 70, 96, dtype=BF16), torch.zeros(1, 2, 70, 40, dtype=BF16),
                torch.zeros(1, 2, 70, 64)):
        with pytest.raises(ValueError):
            ap.persistent_attention(bad, bad, bad, 0.125, layout="headmajor")


# --- on the card ------------------------------------------------------------

# (layout, inputs, H, d): K1 (flat, fused views or contiguous), K2 on
# head-pair views of a fused projection (rank-4 maps) or contiguous packed
# tensors (rank 5), K3 at 64 and 128.
CARD_LAYOUTS = (("fat", "fused", 4, 64), ("fat", "contiguous", 4, 64),
                ("packed", "fused", 4, 64), ("packed", "contiguous", 4, 64),
                ("headmajor", "fused", 3, 64), ("headmajor", "contiguous", 3, 64),
                ("headmajor", "fused", 2, 128), ("headmajor", "contiguous", 2, 128))


def _card_inputs(layout, inputs, B, N, H, d, n_valid, seed=5):
    """q, k and v on the card in ``layout``: views of one fused (B, N, 3 H d)
    projection, or contiguous tensors; NaN in the dead K and V rows."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * d)).astype(np.float32)).to(
        "cuda", BF16)
    if n_valid is not None:
        qkv[:, n_valid:, H * d:] = float("nan")
    views = [qkv[..., j * H * d:(j + 1) * H * d] for j in range(3)]
    if layout != "fat":
        group = 2 if layout == "packed" else 1
        views = [t.view(B, N, H // group, group * d).transpose(1, 2) for t in views]
    return views if inputs == "fused" else [t.contiguous() for t in views]


def _card_tables(N, d, seed=9):
    ang = np.random.default_rng(seed).standard_normal((N, d)).astype(np.float32)
    return tuple(torch.from_numpy(f(ang)).to("cuda") for f in (np.cos, np.sin))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,inputs,H,d", CARD_LAYOUTS)
@pytest.mark.parametrize("N,n_valid", NS)
@pytest.mark.parametrize("rope", [False, True])
def test_persistent_body_matches_plain_and_the_one_warpgroup_body(layout, inputs, H, d, N,
                                                                  n_valid, rope, cuda_device):
    """The persistent body against the plain version (one bf16 ulp, 2^-8 of
    max |v| and 1e-5, as K1-K3 on the card), finite where the dead rows hold
    NaN, dense in q's dim order, and bit for bit the output of the route's
    wrapper (the one-warpgroup body)."""
    q, k, v = _card_inputs(layout, inputs, 2, N, H, d, n_valid)
    cos, sin = _card_tables(N, d) if rope else (None, None)
    scale = d ** -0.5
    got = ap.persistent_attention(q, k, v, scale, n_valid, cos, sin, layout=layout)
    one = ROUTE[layout](q, k, v, scale, n_valid, cos, sin)
    want = PLAIN[layout](q, k, v, scale, n_valid, cos, sin)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert got.stride() == fa._dense_like(q).stride()
    heads = {"fat": lambda t: t.reshape(2, N, H, d), "packed": lambda t: t.transpose(1, 2)
             .reshape(2, N, H, d), "headmajor": lambda t: t.transpose(1, 2)}[layout]
    vmax = heads(v)[:, : n_valid or N].float().abs().max()
    tol = want.float().abs() * 2.0 ** -7 + 2.0 ** -8 * vmax + 1e-5
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,d", [(32, 1205, 12, 64), (8, 1205, 32, 128), (1, 261, 2, 64)])
def test_the_grid_is_the_blocks_the_card_holds(B, N, H, d, cuda_device):
    """The grid is a whole number of blocks an SM, or the item count where
    that is smaller (K3, RoPE on), and its output is the bits of K3's
    wrapper (the one-warpgroup body)."""
    q, k, v = _card_inputs("headmajor", "fused", B, N, H, d, None)
    cos, sin = _card_tables(N, d)
    got = ap.persistent_attention(q, k, v, d ** -0.5, None, cos, sin, layout="headmajor")
    items = B * H * -(-N // 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ap.last_blocks == items or (ap.last_blocks < items and ap.last_blocks % sms == 0)
    assert torch.equal(got, fa.fused_attention(q, k, v, d ** -0.5, None, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 48, 112])
def test_narrower_heads_at_the_64_and_128_builds(d, cuda_device):
    """d below the built width (q roped by the prologue, the kernel without
    tables): the plain version's values, the bits of K3's wrapper (the
    one-warpgroup body in place)."""
    N, nv = 272, 261
    q, k, v = _card_inputs("headmajor", "fused", 2, N, 3, d, nv)
    cos, sin = _card_tables(N, d)
    got = ap.persistent_attention(q, k, v, d ** -0.5, nv, cos, sin, layout="headmajor")
    one = fa.fused_attention(q, k, v, d ** -0.5, nv, cos, sin)
    want = fa.attention_headmajor_reference(q, k, v, d ** -0.5, nv, cos, sin)
    vmax = v.transpose(1, 2)[:, :nv].float().abs().max()
    tol = want.float().abs() * 2.0 ** -7 + 2.0 ** -8 * vmax + 1e-5
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,d", [("attention_fat", 64), ("attention_packed", 64),
                                      ("attention_headmajor", 64),
                                      ("attention_headmajor", 128)])
def test_the_routes_stay_on_the_one_warpgroup_body(kernel, d, cuda_device):
    """K1-K3 in bf16 at 64 / 128 launch the one-warpgroup body
    (launches_sm90, by entry) and not the persistent entry, and the
    persistent body gives their bits."""
    layout = {"attention_fat": "fat", "attention_packed": "packed",
              "attention_headmajor": "headmajor"}[kernel]
    wrapper = ROUTE[layout]
    q, k, v = _card_inputs(layout, "fused", 2, 261, 4, d, None)
    cos, sin = _card_tables(261, d)
    before = (fa.launches_sm90, fa.launches_sm90_by_kernel.get(kernel, 0), ap.launches)
    got = wrapper(q, k, v, d ** -0.5, None, cos, sin)
    assert (fa.launches_sm90, fa.launches_sm90_by_kernel.get(kernel, 0), ap.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert torch.equal(got, ap.persistent_attention(q, k, v, d ** -0.5, None, cos, sin,
                                                    layout=layout))
