"""cbas_tpu_torch's FrameEncoder and encode_file against the JAX package's.

Both encoders load the repository's demo encoder (dinov3, hidden 128, two
64-wide heads) and run in fp32 on the CPU. Their outputs are float16, so
they must agree to within one fp16 ulp of each value: fp32 sums in another
order can round one step apart. Near zero the fp16 ulp falls below the fp32
error of the O(1) terms the value is summed from, so 1e-6 is allowed on top.
"""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import chip_smoke

import jax.numpy as jnp

from cbas_tpu.core.config import EncodeConfig
from cbas_tpu.engine.encode import encode_file as jax_encode_file
from cbas_tpu.models.encoder import FrameEncoder as JaxFrameEncoder
from cbas_tpu_torch.engine.encode import EncodeStats, encode_file
from cbas_tpu_torch.models.encoder import FrameEncoder

DEMO_ENCODER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "examples", "demo_project", "demo_encoder",
)


def assert_within_fp16_ulp(got, want):
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    step = np.spacing(np.abs(want)).astype(np.float32)
    assert (diff <= step + 1e-6).all(), float((diff / step).max())


@pytest.fixture(scope="module")
def encoders():
    return (
        FrameEncoder(DEMO_ENCODER, compute_dtype=torch.float32, device="cpu"),
        JaxFrameEncoder(DEMO_ENCODER, compute_dtype=jnp.float32),
    )


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 48, 80)])
def test_encode_planes_matches_jax(encoders, shape):
    ours, ref = encoders
    planes = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    assert ours.identifier == ref.identifier and ours.embed_dim == ref.embed_dim == 128
    assert_within_fp16_ulp(ours.encode_planes(planes, batch=4), ref.encode_planes(planes, batch=4))


def test_partial_batches_pad_and_slice(encoders):
    enc, _ = encoders
    planes = np.random.default_rng(1).integers(0, 256, (8, 64, 64), np.uint8)
    full = enc.encode_planes(planes, batch=8)
    part = enc.encode_planes(planes[:5], batch=8)  # padded to 8, sliced to 5
    assert part.shape == (5, 128) and part.dtype == np.float16
    np.testing.assert_array_equal(part, full[:5])
    pending = enc.encode_planes_async(planes[:3], batch=8)
    assert pending[1] == 3 and pending[2] is True  # the (8, 64, 64) state is cached
    with pytest.raises(ValueError, match="do not fit"):
        enc.encode_planes(planes, batch=4)


def test_encode_rgb_equals_encode_planes(encoders):
    enc, _ = encoders
    frames = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3), np.uint8)
    np.testing.assert_array_equal(enc.encode_rgb(frames), enc.encode_planes(frames[..., 1].copy()))
    np.testing.assert_array_equal(enc(frames), enc.encode_rgb(frames))


def test_bf16_tracks_fp32(encoders):
    """The production bf16 path (tanh GELU, single-pass LayerNorm) stays
    within cosine 0.99 of fp32 per frame, the bound the GPU smoke run uses."""
    fp32, _ = encoders
    bf16 = FrameEncoder(DEMO_ENCODER, device="cpu")
    assert bf16.cfg.gelu_approximate and bf16.compute_dtype == torch.bfloat16
    planes = np.random.default_rng(3).integers(0, 256, (4, 64, 64), np.uint8)
    a = bf16.encode_planes(planes).astype(np.float32)
    b = fp32.encode_planes(planes).astype(np.float32)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.99, cos


def test_head_dim_128_checkpoint_dir_matches_jax(tmp_path):
    """A local checkpoint directory whose config.json has 128-wide heads and a
    gated MLP (DINOv3 ViT-7B's shape at a small width) resolves, initialises
    and encodes through the head-major route, as the JAX package's does."""
    import json

    from cbas_tpu_torch.models.vit import init_vit_params

    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "dinov3_vit", "hidden_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 512, "use_gated_mlp": True,
        "patch_size": 16, "num_register_tokens": 4, "rope_theta": 100.0,
        "layer_norm_eps": 1e-5,
    }))
    ours = FrameEncoder(str(tmp_path), random_init=True, compute_dtype=torch.float32,
                        device="cpu")
    assert ours.cfg.head_dim == 128 and ours.cfg.use_gated_mlp
    params = init_vit_params(0, ours.cfg)
    ref = JaxFrameEncoder(str(tmp_path), params=params, compute_dtype=jnp.float32)
    assert dataclasses.asdict(ref.cfg) == dataclasses.asdict(ours.cfg)
    planes = np.random.default_rng(4).integers(0, 256, (3, 48, 80), np.uint8)
    assert_within_fp16_ulp(ours.encode_planes(planes, batch=4), ref.encode_planes(planes, batch=4))


@pytest.mark.parametrize("variant", ["dinov2", "dinov3"])
def test_hf_checkpoint_dir_matches_jax(variant, tmp_path):
    """A checkpoint saved by Hugging Face's own module (config.json and
    model.safetensors, the masked-image-modelling token among its weights)
    loads and encodes as in the JAX package."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(2)
    if variant == "dinov2":
        hf_cfg = transformers.Dinov2WithRegistersConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2, patch_size=16,
            image_size=32, num_register_tokens=4)
        model = transformers.Dinov2WithRegistersModel(hf_cfg)
    else:
        hf_cfg = transformers.DINOv3ViTConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2, patch_size=16,
            image_size=32, num_register_tokens=4, intermediate_size=256)
        model = transformers.DINOv3ViTModel(hf_cfg)
    assert "embeddings.mask_token" in model.state_dict()
    path = str(tmp_path / f"{variant}-tiny")
    model.eval().save_pretrained(path)
    ours = FrameEncoder(path, compute_dtype=torch.float32, device="cpu")
    ref = JaxFrameEncoder(path, compute_dtype=jnp.float32)
    planes = np.random.default_rng(5).integers(0, 256, (3, 48, 64), np.uint8)
    assert_within_fp16_ulp(ours.encode_planes(planes, batch=4), ref.encode_planes(planes, batch=4))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameEncoder(DEMO_ENCODER, device="cuda")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A tiny structured 64x64 clip, one copy per package (each writes its
    H5 beside the video)."""
    paths = []
    for who in ("torch", "jax"):
        path = str(tmp_path_factory.mktemp(who) / "cam_00001.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
        rng = np.random.default_rng(0)
        for i in range(40):
            frame = rng.integers(0, 256, (64, 64, 3), np.uint8)
            frame[:, :, 1] = (np.arange(64)[:, None] * 3 + 5 * i) % 256
            w.write(frame)
        w.release()
        paths.append(path)
    return paths


def test_encode_file_h5_matches_jax(encoders, clip):
    ours, ref = encoders
    cfg = EncodeConfig(chunk_frames=16, h5_chunk_rows=32)
    stats = EncodeStats()
    got_path = encode_file(ours, clip[0], config=cfg, stats=stats)
    want_path = jax_encode_file(ref, clip[1], config=cfg)
    assert got_path.endswith("cam_00001_cls.h5") and stats.frames == 40
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        assert dict(g.attrs) == dict(w.attrs)
        assert g["cls"].shape == w["cls"].shape == (40, 128)
        assert g["cls"].dtype == w["cls"].dtype == np.dtype("f2")
        assert g["cls"].chunks == w["cls"].chunks
        assert_within_fp16_ulp(g["cls"][:], w["cls"][:])


class _TruncatingReader:
    """A decoder whose every chunk after the first comes back 3 frames short;
    with ``cancel``, it sets that event instead as it reads the second chunk
    (a user cancelling mid-file)."""

    def __init__(self, inner, cancel=None):
        self._inner = inner
        self._cancel = cancel
        self.frame_count = inner.frame_count

    def __len__(self):
        return self._inner.frame_count

    def read_green_batch(self, start, count):
        got = self._inner.read_green_batch(start, count)
        if self._cancel is not None:
            if start > 0:
                self._cancel.set()
            return got
        return got[: count - 3] if start > 0 else got

    def close(self):
        self._inner.close()


def _same_rows(data):
    """(N, N) bool: row i equals row j exactly."""
    return (data[:, None, :] == data[None, :, :]).all(-1)


# Each case: the geometry, EncodeConfig fields, and what else it does.
REUSE_CASES = {
    "exact_threshold_1": ((64, 64), dict(reuse_threshold=1.0, chunk_frames=16), None),
    "inter_area_threshold_6": ((64, 64), dict(reuse_threshold=6.0, chunk_frames=16), None),
    "ragged_tiles": ((80, 48), dict(reuse_threshold=4.0, reuse_tile=32, chunk_frames=16), None),
    "whole_frame_mad": ((64, 64), dict(reuse_threshold=3.0, reuse_tile=0, chunk_frames=16), None),
    "partial_key_batch": ((64, 64), dict(reuse_threshold=2.0, chunk_frames=12), None),
    "truncation": ((64, 64), dict(reuse_threshold=1.0, chunk_frames=16), "truncate"),
    "cancel_mid_file": ((64, 64), dict(reuse_threshold=1.0, chunk_frames=16), "cancel"),
}


@pytest.mark.parametrize("case", sorted(REUSE_CASES))
def test_reuse_gated_encode_matches_jax(case, encoders, tmp_path, monkeypatch):
    """The reuse-gated encode (reuse_threshold > 0) of one clip through both
    packages: the same key and reuse counts, the same row-to-key pattern,
    the same H5 layout, and rows within one fp16 ulp."""
    import threading

    from cbas_tpu.engine import encode as jax_encode
    from cbas_tpu_torch.engine import encode as port_encode

    (width, height), fields, action = REUSE_CASES[case]
    cfg = EncodeConfig(h5_chunk_rows=32, **fields)
    results = []
    for mod, enc in ((port_encode, encoders[0]), (jax_encode, encoders[1])):
        video = tmp_path / mod.__name__.split(".")[0] / "cam_00001.mp4"
        video.parent.mkdir()
        chip_smoke.write_spans_clip(str(video), 70, width, height)
        cancel = threading.Event() if action == "cancel" else None
        if action is not None:
            real_open = mod.open_video
            monkeypatch.setattr(mod, "open_video",
                                lambda p, o=real_open, c=cancel: _TruncatingReader(o(p), c))
        stats = mod.EncodeStats()
        out = mod.encode_file(enc, str(video), config=cfg, cancel_event=cancel, stats=stats)
        leftovers = sorted(f for f in os.listdir(video.parent) if f.endswith((".h5", ".tmp")))
        results.append((out, stats, leftovers))
    (got_path, got, got_files), (want_path, want, want_files) = results
    assert (got.key_frames, got.reused_frames, got.frames) == \
        (want.key_frames, want.reused_frames, want.frames)
    assert got_files == want_files
    if action == "cancel":
        assert got_path is None and want_path is None and got_files == []
        return
    n = 16 + 13 if action == "truncate" else 70  # a short second chunk ends the file
    assert got.frames == n and got.key_frames > 1 and got.reused_frames > 0
    assert got.key_frames + got.reused_frames == n
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        assert dict(g.attrs) == dict(w.attrs)
        assert g["cls"].shape == w["cls"].shape == (n, 128)
        assert g["cls"].dtype == w["cls"].dtype == np.dtype("f2")
        assert g["cls"].chunks == w["cls"].chunks
        ours, theirs = g["cls"][:], w["cls"][:]
    np.testing.assert_array_equal(_same_rows(ours), _same_rows(theirs))
    assert_within_fp16_ulp(ours, theirs)
