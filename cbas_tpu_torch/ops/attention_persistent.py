"""The persistent Hopper body of the fused attention, at head dims 64 and 128.

``csrc/attention_sm90_persistent.cuh`` is a redesign of the one-warpgroup
Hopper body (``csrc/attention_sm90.cuh``) at the widths every DINO
checkpoint has: 64 (K1, K2, K3) and 128 (K3 at the ViT-7B width). It computes
the same function, bit for bit, through the same tensor maps and RoPE
prologue; what differs is how the work is laid on the card:

- a grid of the blocks the card holds at once, each walking work items (one
  64-row query tile of one image and head, :func:`work_item`) taken from a
  counter in device memory, so the items in flight stay a compact run in
  (image, head, tile) order;
- a ring of K and V tiles that spans work items, Q double-buffered and its
  next tile loaded one item ahead;
- Q roped and scaled by a warp of its own, off the consumers' chain.

No route calls it: at every main shape it measured slower than the
one-warpgroup body K1-K3 run (``PERF.md`` §6, PR 24), so it stays a timing
case, as the two-consumer body at 128 does. :func:`persistent_attention`
runs it; K1-K3's own wrappers (``flash_attention.fused_attention_fat``,
``fused_attention_packed`` and ``fused_attention``) run the one-warpgroup
body it is held against, bit for bit, and timed beside:

- on a CUDA tensor it launches the kernel (``csrc/attention_persistent.cu``)
  or raises; it does not fall back;
- on a CPU tensor it runs the plain version of K1-K3 in the layout given.

``launches`` counts its kernel launches and nothing else, under a lock;
``last_blocks`` is the grid the last launch ran (the blocks the card holds
at once, or fewer).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from cbas_tpu_torch.ops import flash_attention as fa

QUERY_TILE = 64  # query rows a block takes an item (csrc kWGRows)
LAYOUTS = ("fat", "packed", "headmajor")
WIDTHS = (64, 128)

launches = 0
last_blocks = 0  # the grid of the last launch
_count_lock = threading.Lock()


def work_item(i: int, H: int, N: int) -> tuple:
    """Item i of the persistent body's walk (csrc ``work_item``): (image,
    head, query tile), i = (b H + h) T + t with T = ceil(N / 64) tiles a
    head, so consecutive items share a head's K and V."""
    n_qt = -(-N // QUERY_TILE)
    bh, t = divmod(i, n_qt)
    b, h = divmod(bh, H)
    return b, h, t


def persistent_grid(B: int, N: int, H: int, resident: int) -> int:
    """The blocks the persistent body launches: those the card holds at
    once (``resident``), or fewer where there are fewer work items."""
    return min(resident, B * H * -(-N // QUERY_TILE))


def persistent_walk(B: int, N: int, H: int, blocks: int, seed: int = 0) -> list:
    """A walk of the persistent body's grid as its kernel takes items: each
    of ``blocks`` blocks fetches the next item from one counter when it
    needs one, in an order the card decides (here a random one from
    ``seed``), until the counter passes the items' count. Returns the
    (block, item) pairs in the order they were taken; each block's last
    fetch (past the walk) ends it."""
    import random

    n_items = B * H * -(-N // QUERY_TILE)
    rng = random.Random(seed)
    counter, live, out = 0, list(range(blocks)), []
    while live:
        block = rng.choice(live)
        item, counter = counter, counter + 1
        if item >= n_items:
            live.remove(block)
        else:
            out.append((block, item))
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``cbas_attention_persistent`` of
    ``csrc/attention_persistent.cu``: K3's signature up to the stream
    (``flash_attention._kernel``), then heads_per_group, the work counter's
    4 bytes and where the grid's blocks go."""
    from cbas_tpu_torch.ops import _cuda

    fn = _cuda.load("attention_persistent").cbas_attention_persistent
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int)]
    return fn


def _heads(q: torch.Tensor, layout: str) -> tuple:
    """(B, N, H, d) of q in ``layout``; raises on what the layout lacks."""
    if layout == "fat" and q.dim() == 3 and q.shape[-1] % fa.HEAD_DIM == 0:
        B, N, D = q.shape
        return B, N, D // fa.HEAD_DIM, fa.HEAD_DIM
    if layout == "packed" and q.dim() == 4 and q.shape[-1] == 2 * fa.HEAD_DIM:
        B, G, N, _ = q.shape
        return B, N, 2 * G, fa.HEAD_DIM
    if layout == "headmajor" and q.dim() == 4:
        B, H, N, d = q.shape
        return B, N, H, d
    raise ValueError(f"q of shape {tuple(q.shape)} is not a {layout} tensor")


def persistent_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    n_valid: Optional[int] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    *,
    layout: str,
) -> torch.Tensor:
    """K1's, K2's or K3's function (``layout`` "fat", "packed" or
    "headmajor") through the persistent body; returns q's shape and dtype,
    dense in q's dim order.

    bf16 only; heads of 64 (K3: a multiple of 16 up to 64, or 112 and 128),
    read in place; q, k and v may be strided views under K1-K3's rule.
    ``rope_cos``/``rope_sin`` are (N, d) tables. Raises ``ValueError`` on
    anything else, on every device."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, not {layout!r}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the persistent body is built for bfloat16, not {q.dtype}")
    B, N, H, d = _heads(q, layout)
    if d % fa.STAGE_ROW_UNIT or fa.headmajor_width(q.dtype, d) not in WIDTHS:
        raise ValueError(f"the persistent body reads heads of d % 16 == 0 at widths {WIDTHS} in "
                         f"place, not {d}")
    nv = fa._check(q, k, v, N, d, n_valid, rope_cos, rope_sin)
    fa._check_strides(("q", "k", "v"), q, k, v)
    if q.device.type == "cpu":
        plain = {"fat": fa.attention_fat_reference, "packed": fa.attention_packed_reference,
                 "headmajor": fa.attention_headmajor_reference}[layout]
        return fa._in_dense_order(q, plain(q, k, v, scale, nv, rope_cos, rope_sin))
    if q.device.type != "cuda":
        raise ValueError(f"persistent_attention runs on cpu or cuda, not {q.device}")
    width = fa.headmajor_width(q.dtype, d)
    cos = sin = None
    if rope_cos is not None:
        cos, sin = (t.to(torch.float32).contiguous() for t in (rope_cos, rope_sin))
    fa._require_contiguous(rope_cos=cos, rope_sin=sin)
    heads_per_group = {"fat": H, "packed": 2, "headmajor": 1}[layout]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        out = fa._dense_like(q)
        counter = torch.empty(1, dtype=torch.int32, device=q.device)  # zeroed by the launch
        q_scratch = k_scratch = None
        if cos is not None:  # the RoPE prologue's scratch, as K1-K3 allocate it
            k_scratch = fa._dense_like(q)
            q_scratch = fa._dense_like(q) if d < width else None
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (cos, sin, q_scratch, k_scratch)),
            B, N, H, d, *fa._layout(q), *fa._layout(out), nv, float(scale),
            torch.cuda.current_stream().cuda_stream, heads_per_group, counter.data_ptr(),
            ctypes.byref(blocks),
        )
    if err:
        raise RuntimeError(f"persistent_attention failed with CUDA error {err}")
    global launches, last_blocks
    with _count_lock:
        launches += 1
        last_blocks = blocks.value
    return out
