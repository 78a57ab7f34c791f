"""The pipe loop of the Hopper body at head dims 64 and 128, on the card.

``csrc/attention_sm90.cuh``'s variant ``kPipe`` (the port of probe2's
``pipe_kernel``) runs FA3's in-warpgroup overlap: tile t + 1's q.k^T and
tile t's p.V in flight under tile t + 1's softmax, at a register budget and
ring of its own (``Launch``). It computes K1's, K2's and K3's function bit
for bit: these tests hold it, through ``attention_variants.attention_variant``,
against what K1-K3's own wrappers launch on the same inputs, and check the
launch configuration the built library reports. Its CPU tests (the launch
table, the plain version) are in ``test_torch_attention_variants.py``, which
imports JAX; this file does not, so it runs on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_attention_pipe.py
"""

import numpy as np
import pytest
import torch

from cbas_tpu_torch.ops import attention_variants as av
from cbas_tpu_torch.ops import flash_attention as fa

BF16 = torch.bfloat16
# (N, n_valid): whole key tiles and not, odd and even key tile counts, NaN in
# the dead rows where n_valid < N.
NS = ((261, None), (272, 261), (329, 300), (1205, None), (1216, 1205))
ROUTE = {"fat": fa.fused_attention_fat, "packed": fa.fused_attention_packed,
         "headmajor": fa.fused_attention}
# (layout, inputs, H, d): views of one fused projection (rank-4 maps) and
# contiguous tensors (packed: rank 5), K3 at 64 and 128.
CARD_LAYOUTS = (("fat", "fused", 4, 64), ("fat", "contiguous", 4, 64),
                ("packed", "fused", 4, 64), ("packed", "contiguous", 4, 64),
                ("headmajor", "fused", 3, 64), ("headmajor", "fused", 2, 128),
                ("headmajor", "contiguous", 2, 128))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (run on the card)")
    return torch.device("cuda")


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
def test_pipe_is_the_routes_bits(layout, inputs, H, d, N, n_valid, rope, cuda_device):
    """The pipe loop gives, bit for bit, what K1's, K2's or K3's wrapper
    gives on the same inputs, finite where the dead rows hold NaN, dense in
    q's dim order, one counted launch a call."""
    q, k, v = _card_inputs(layout, inputs, 2, N, H, d, n_valid)
    cos, sin = _card_tables(N, d) if rope else (None, None)
    want = ROUTE[layout](q, k, v, d ** -0.5, n_valid, cos, sin)
    before = av.launches_by_variant.get("pipe", 0)
    got = av.attention_variant(q, k, v, d ** -0.5, n_valid, cos, sin, variant="pipe",
                               layout=layout)
    torch.cuda.synchronize()
    assert av.launches_by_variant["pipe"] == before + 1
    assert got.stride() == fa._dense_like(q).stride()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_the_library_builds_the_launch_the_wrapper_expects(d, cuda_device):
    """The built library's stages and blocks an SM for variant 0 and each
    variant are the wrapper's table (``av.launch_config``), and the card
    keeps that many blocks of each build resident on an SM."""
    for variant in ("full",) + av.VARIANTS:
        got = av.library_launch_config(variant, d)
        want = av.launch_config(variant, d)
        assert {k: got[k] for k in want} == want, variant
        assert got["resident_blocks"] >= want["min_blocks"], (variant, got)
