"""cbas_tpu_torch's device mesh (``parallel/``) through the production entry
points, case by case as ``tests/test_parallel_production.py`` drives the
JAX package's, plus cross-package cases.

The port runs a mesh in one process, one thread a shard. Here every shard is
a logical shard of the CPU (``make_mesh(devices=["cpu"] * 8)``), the
counterpart of the JAX suite's 8 virtual CPU devices. Each sharded run must
equal the one-device port at the JAX suite's tolerance, and the (data=4,
model=2) encode must equal ``cbas_tpu``'s over JAX's 8 CPU devices on the same
numpy weights.
"""

import os
import threading

import numpy as np
import pandas as pd
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu.models import vit as jvit
from cbas_tpu.models.encoder import FrameEncoder as JaxFrameEncoder
from cbas_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cbas_tpu_torch.core.config import EncodeConfig, InferenceConfig
from cbas_tpu_torch.engine.classifier import ClassifierBundle
from cbas_tpu_torch.engine.data import WindowSource
from cbas_tpu_torch.engine.encode import encode_file
from cbas_tpu_torch.engine.infer import InferenceSession
from cbas_tpu_torch.engine.train import train_head
from cbas_tpu_torch.models import vit as tvit
from cbas_tpu_torch.models.encoder import FrameEncoder
from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params
from cbas_tpu_torch.models.vit import PRESETS, ViTConfig, init_vit_params
from cbas_tpu_torch.parallel import mesh as pmesh
from cbas_tpu_torch.parallel.mesh import (
    AllReduce,
    Mesh,
    data_axis_size,
    make_mesh,
    pad_to_multiple,
    run_shards,
    runtime_mesh,
)
from cbas_tpu_torch.parallel.tp import shard_vit_params, vit_param_pspecs

RES = 32
SMALL_CFG = ViTConfig(
    variant="dinov3", hidden_size=64, num_layers=2, num_heads=2, patch_size=16,
    num_register_tokens=4, intermediate_size=128, layer_norm_eps=1e-5,
)


def hdf5_store():
    """The port's HDF5 store, imported where a test writes or reads a file
    (it needs h5py, which the card's host lacks; its tests there are the
    ``cuda`` ones)."""
    from cbas_tpu_torch.core import hdf5_store as store

    return store


def assert_within_fp16_ulp(got, want):
    """fp16 embeddings within one fp16 ulp (+1e-6) of each value: a shard's
    GEMMs run on fewer rows, which the CPU's BLAS may block differently, so
    the fp32 sums can round one fp16 step apart (the bound
    ``tests/test_torch_encoder.py`` holds the port to against the JAX
    package)."""
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    step = np.spacing(np.abs(want)).astype(np.float32)
    assert (diff <= step + 1e-6).all(), float((diff / step).max())


def cpu_mesh(shape=(8,), axis_names=("data",)):
    """Logical CPU shards, one per mesh entry."""
    return make_mesh(shape, axis_names, ["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def mesh():
    return cpu_mesh()


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vids") / "subj_00001.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (RES, RES))
    rng = np.random.default_rng(7)
    for i in range(90):
        frame = rng.integers(0, 256, (RES, RES, 3), np.uint8)
        frame[:, :, 1] = (np.arange(RES)[None, :] * 5 + i * 3) % 256
        w.write(frame)
    w.release()
    return path


def fake_cuda(monkeypatch, n):
    """``n`` visible CUDA devices, as far as runtime_mesh can tell."""
    monkeypatch.setattr(pmesh, "_cuda_devices", lambda: [torch.device("cuda", i) for i in range(n)])


def test_runtime_mesh_uses_all_devices(monkeypatch):
    fake_cuda(monkeypatch, 8)
    m = runtime_mesh()
    assert m is not None and m.devices.size == 8 and m.axis_names == ("data",)
    assert m.distinct_devices() == [torch.device("cuda", i) for i in range(8)]
    fake_cuda(monkeypatch, 1)
    assert runtime_mesh() is None  # one device and no configured shape: no mesh


def test_runtime_mesh_refuses_more_devices_than_visible(monkeypatch):
    from cbas_tpu_torch.core.config import RuntimeConfig

    fake_cuda(monkeypatch, 2)
    with pytest.raises(ValueError, match=r"mesh shape \(4, 2\) needs 8 devices, have 2"):
        runtime_mesh(RuntimeConfig(mesh_shape=[4, 2]))


def test_runtime_mesh_from_project_yaml(tmp_path, monkeypatch):
    """cbas_config.yaml runtime.mesh_shape gives the mesh; axis names
    default for a bare 2-D shape."""
    from cbas_tpu_torch.core.config import ProjectSettings, dump_yaml
    from cbas_tpu_torch.core.project import Project

    fake_cuda(monkeypatch, 8)
    proj = Project.create_project(str(tmp_path), "p")
    dump_yaml(
        {"encoder_model_identifier": "x", "runtime": {"mesh_shape": [4, 2]}},
        os.path.join(proj.path, "cbas_config.yaml"),
    )
    proj.reload_settings()
    assert proj.settings.runtime.mesh_shape == [4, 2]
    m = runtime_mesh(proj.settings.runtime)
    assert dict(m.shape) == {"data": 4, "model": 2}
    s = ProjectSettings.from_dict({"runtime": {"mesh_shape": [8]}})
    assert runtime_mesh(s.runtime).axis_names == ("data",)


def test_mesh_of_invisible_cuda_devices_is_refused():
    m = make_mesh(devices=["cuda", "cuda:1"])  # "cuda" is the current device, indexed
    assert m.shape == {"data": 2} and data_axis_size(m) == 2
    assert m.distinct_devices()[1] == torch.device("cuda", 1)
    assert m.first_device.index is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="the mesh needs cuda:0, which is not visible"):
            FrameEncoder("e", params=init_vit_params(0, SMALL_CFG), cfg=SMALL_CFG, mesh=m)


def test_weights_device_names_each_device_once():
    """``weights_device`` (the app's ``encoder_device``) for an encoder made
    with a device name the tensors do not repeat ("cpu:0" places them on
    "cpu", as "cuda" places them on "cuda:0"), and for a mesh."""
    params = init_vit_params(0, SMALL_CFG)
    one = FrameEncoder("e", params=params, cfg=SMALL_CFG, device="cpu:0")
    assert one.weights_device == "cpu"
    sharded = FrameEncoder("e", params=params, cfg=SMALL_CFG,
                           mesh=cpu_mesh((2, 2), ("data", "model")))
    assert sharded.weights_device == "cpu"


def test_encode_file_dp_matches_single_device(video_path, mesh, tmp_path):
    params = init_vit_params(0, SMALL_CFG)
    enc_1 = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                         device="cpu")
    enc_dp = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                          mesh=mesh)

    # chunk 40 is NOT a multiple of 8: the encoder must round the batch up
    # to a mesh multiple and slice the padding back off.
    cfg = EncodeConfig(chunk_frames=40)
    out = encode_file(enc_1, video_path, config=cfg)
    single = hdf5_store().read_all(out)
    os.remove(out)
    out = encode_file(enc_dp, video_path, config=cfg)
    dp = hdf5_store().read_all(out)

    assert dp.shape == single.shape == (90, 64)
    assert_within_fp16_ulp(dp, single)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    cfg = DeltasHeadConfig(in_features=64, out_features=3, seq_len=7, lstm_hidden_size=16)
    b = ClassifierBundle(
        name="dpmodel", behaviors=["a", "b", "c"], seq_len=7,
        params=init_deltas_params(3, cfg), lstm_hidden_size=16, lstm_layers=1,
        temperature=1.2, encoder_identifier="e",
    )
    d = str(tmp_path_factory.mktemp("m") / "dpmodel")
    b.save(d)
    return ClassifierBundle.load(d)


def test_infer_h5_dp_matches_single_device(bundle, mesh, tmp_path):
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(150, 64)).astype(np.float16)
    h5 = str(tmp_path / "x_cls.h5")
    with hdf5_store().EmbeddingWriter(h5, encoder_identifier="e", embed_dim=64) as w:
        w.append(feats)

    # window_batch 20 is not a mesh multiple: the session must pad it.
    cfg = InferenceConfig(chunk_frames=60, window_batch=20)
    csv_1 = InferenceSession(bundle, cfg, device="cpu").infer_h5(
        h5, output_csv=str(tmp_path / "s.csv"))
    session = InferenceSession(bundle, cfg, mesh=mesh)
    assert session._window_batch == 24
    csv_dp = session.infer_h5(h5, output_csv=str(tmp_path / "dp.csv"))
    single = pd.read_csv(csv_1).to_numpy()
    dp = pd.read_csv(csv_dp).to_numpy()
    assert dp.shape == single.shape == (150, 3)
    np.testing.assert_allclose(dp, single, rtol=1e-5, atol=1e-6)


def _make_sources(tmp_path, seq_len=7, n_frames=400):
    rng = np.random.default_rng(5)
    h5 = str(tmp_path / "train_cls.h5")
    with hdf5_store().EmbeddingWriter(h5, encoder_identifier="e", embed_dim=32) as w:
        # Two separable behavior clusters so one epoch actually learns.
        feats = rng.normal(size=(n_frames, 32)).astype(np.float16)
        feats[: n_frames // 2, :4] += 3.0
        w.append(feats)
    half = seq_len // 2
    manifest = [
        (h5, c, 0 if c < n_frames // 2 else 1)
        for c in range(half, n_frames - half)
    ]
    return WindowSource(manifest[::2], seq_len), WindowSource(manifest[1::2], seq_len)


@pytest.mark.parametrize("device_data", [True, False])
def test_train_head_dp_matches_single_device(mesh, tmp_path, device_data):
    """Two epochs with dropout on: the data-parallel head equals the
    one-device head at the JAX suite's tolerance."""
    torch.set_num_threads(1)
    train, val = _make_sources(tmp_path)
    kw = dict(
        seq_len=7, behaviors=["a", "b"], batch_size=48,
        lr=1e-3, epochs=2, patience=5, lstm_hidden_size=8, seed=0,
        device_data=device_data, device="cpu",
    )
    p1, rep1, be1 = train_head(train, val, **kw)
    pdp, repdp, bedp = train_head(train, val, **kw, mesh=mesh)
    assert p1 is not None and pdp is not None
    assert be1 == bedp and len(rep1) == len(repdp)
    for k in p1:
        np.testing.assert_allclose(
            pdp[k], p1[k], rtol=5e-4, atol=5e-5,
            err_msg=f"param {k} diverged between single-device and DP training",
        )


def test_distinct_devices_take_the_copying_paths(tmp_path):
    """"cpu" and "cpu:0" are distinct mesh devices whose tensors lie on the
    same memory, so a mesh of both runs the paths that distinct cards take
    (a head replica refreshed and its gradients summed back, weights placed
    per device, the model-axis sum moved between devices) and can be held to
    the one-device run here."""
    torch.set_num_threads(1)
    devices = [torch.device("cpu"), torch.device("cpu", 0)]
    train, val = _make_sources(tmp_path)
    kw = dict(seq_len=7, behaviors=["a", "b"], batch_size=48, lr=1e-3, epochs=2, patience=5,
              lstm_hidden_size=8, seed=0, device="cpu")
    p1, _, be1 = train_head(train, val, **kw)
    pdp, _, bedp = train_head(train, val, **kw, mesh=make_mesh(devices=devices))
    assert be1 == bedp
    for k in p1:
        np.testing.assert_allclose(pdp[k], p1[k], rtol=5e-4, atol=5e-5, err_msg=k)

    params = init_vit_params(11, SMALL_CFG)
    planes = np.random.default_rng(12).integers(0, 256, (9, RES, RES), np.uint8)
    want = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                        device="cpu").encode_planes(planes)
    enc = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                       mesh=make_mesh((2, 2), ("data", "model"), devices + devices[::-1]))
    assert len({id(s.params["layer.0.attention.q_proj.weight"]) for row in enc._shards
                for s in row}) == 4  # one slice per (device, model rank)
    np.testing.assert_allclose(enc.encode_planes(planes).astype(np.float32),
                               want.astype(np.float32), rtol=2e-3, atol=2e-3)


def test_train_head_dp_rounds_batch_to_mesh_multiple(mesh, tmp_path, monkeypatch):
    from cbas_tpu_torch.engine import train as ttrain

    sizes = []
    original = ttrain.build_train_step

    def recording(*args, **kwargs):
        step = original(*args, **kwargs)

        def wrapped(*a, **k):
            sizes.append(len(a[1]))  # x (host path) or centers (device path)
            return step(*a, **k)
        return wrapped

    monkeypatch.setattr(ttrain, "build_train_step", recording)
    torch.set_num_threads(1)
    train, val = _make_sources(tmp_path, n_frames=120)
    p, reports, be = train_head(
        train, val, seq_len=7, behaviors=["a", "b"], batch_size=52,
        lr=1e-3, epochs=1, patience=5, lstm_hidden_size=8, seed=0, mesh=mesh,
    )
    assert p is not None and reports
    assert sizes and set(sizes) == {56}  # 52 rounded up to the data axis (8)


def test_api_load_project_builds_mesh(tmp_path, monkeypatch):
    """``Api(device="cuda").load_project`` builds ``runtime_mesh`` from the
    project's settings and hands it to the encoder. The cards are stood in
    for by logical CPU shards (the only part faked: which devices exist)."""
    from cbas_tpu_torch.app.api import Api
    from cbas_tpu_torch.core.project import Project

    proj = Project.create_project(str(tmp_path), "p")
    params = init_vit_params(0, SMALL_CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pmesh, "_cuda_devices", lambda: [torch.device("cpu")] * 8)

    def fake_encoder(identifier, **kw):
        return FrameEncoder(identifier, params=params, cfg=SMALL_CFG,
                            compute_dtype=torch.float32, mesh=kw.get("mesh"))

    monkeypatch.setattr("cbas_tpu_torch.models.encoder.FrameEncoder", fake_encoder)
    api = Api(device="cuda")
    try:
        assert api.load_project(proj.path)["success"]
        st = api.state
        assert st.mesh is not None and st.mesh.devices.size == 8
        assert st.encoder.mesh is st.mesh
    finally:
        api.kill_all_processes()


def test_api_on_the_cpu_gets_no_mesh(tmp_path, monkeypatch):
    from cbas_tpu_torch.app.api import Api
    from cbas_tpu_torch.core.project import Project

    proj = Project.create_project(str(tmp_path), "p")
    monkeypatch.setattr(pmesh, "_cuda_devices", lambda: [torch.device("cuda", i) for i in range(8)])
    api = Api(device="cpu")
    try:
        api.load_project(proj.path)
        assert api.state.mesh is None
    finally:
        api.kill_all_processes()


def test_encode_planes_dp_tp_2d_mesh_matches_single_device():
    """FrameEncoder over a (data=4, model=2) mesh: tensor-parallel ViT params
    (head/intermediate shards, summed out-projections) reproduce the
    single-device embeddings."""
    params = init_vit_params(11, SMALL_CFG)
    planes = np.random.default_rng(12).integers(0, 256, (9, RES, RES), np.uint8)  # pads to 12

    single = FrameEncoder("tp-enc", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                          device="cpu")
    want = single.encode_planes(planes)
    enc = FrameEncoder("tp-enc", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                       mesh=cpu_mesh((4, 2), ("data", "model")))
    got = enc.encode_planes(planes)
    assert got.shape == want.shape == (9, 64)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3,
                               atol=2e-3)
    # The large weights really are sharded: each model shard's q projection
    # holds half the output rows, and the two halves make the whole.
    name = "layer.0.attention.q_proj.weight"
    for row in enc._shards:
        assert [tuple(s.params[name].shape) for s in row] == [(32, 64)] * 2
        whole = torch.cat([s.params[name] for s in row]).numpy()
        np.testing.assert_array_equal(whole, params[name])


def test_encode_planes_tp_indivisible_falls_back_to_replication():
    """A model axis that does not divide the heads replicates those weights
    (and skips their sum) instead of wrecking the math."""
    cfg = ViTConfig(
        variant="dinov3", hidden_size=96, num_layers=1, num_heads=3, patch_size=16,
        num_register_tokens=4, intermediate_size=96, layer_norm_eps=1e-5,
    )
    params = init_vit_params(13, cfg)
    planes = np.random.default_rng(14).integers(0, 256, (8, RES, RES), np.uint8)
    want = FrameEncoder("f", params=params, cfg=cfg, compute_dtype=torch.float32,
                        device="cpu").encode_planes(planes)
    enc = FrameEncoder("f", params=params, cfg=cfg, compute_dtype=torch.float32,
                       mesh=cpu_mesh((4, 2), ("data", "model")))
    got = enc.encode_planes(planes)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3,
                               atol=2e-3)
    shard = enc._shards[0][1].params
    assert tuple(shard["layer.0.attention.q_proj.weight"].shape) == (96, 96)  # replicated
    assert tuple(shard["layer.0.mlp.up_proj.weight"].shape) == (48, 96)       # split


def test_infer_pads_window_batch_to_data_axis_only():
    """On a (data=4, model=2) mesh the window batch pads to 4, not 8."""
    cfg = DeltasHeadConfig(in_features=32, out_features=2, seq_len=7, lstm_hidden_size=8)
    bundle = ClassifierBundle(
        name="m", behaviors=["a", "b"], seq_len=7, params=init_deltas_params(5, cfg),
        lstm_hidden_size=8, encoder_identifier="e",
    )
    s = InferenceSession(bundle, InferenceConfig(chunk_frames=64, window_batch=10),
                         mesh=cpu_mesh((4, 2), ("data", "model")))
    assert s._window_batch == 12  # next multiple of data=4, NOT of 8 -> 16
    feats = np.random.default_rng(6).normal(size=(30, 32)).astype(np.float16)
    probs = s.predict_frames(feats, pad_front=3, pad_back=3)
    assert probs.shape == (30, 2)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    want = InferenceSession(bundle, InferenceConfig(chunk_frames=64, window_batch=10),
                            device="cpu").predict_frames(feats, pad_front=3, pad_back=3)
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)


def test_encode_planes_dp_tp_at_real_preset_width():
    """DP x TP at the ViT-B preset width (768 hidden, 12 heads, 3072
    intermediate), 2 layers, every sharded matmul at production dims."""
    torch.set_num_threads(2)
    cfg = ViTConfig(
        variant="dinov3", hidden_size=768, num_layers=2, num_heads=12,
        patch_size=16, num_register_tokens=4, intermediate_size=3072,
        layer_norm_eps=1e-5,
    )
    params = init_vit_params(21, cfg)
    planes = np.random.default_rng(22).integers(0, 256, (8, RES, RES), np.uint8)
    want = FrameEncoder("b16", params=params, cfg=cfg, compute_dtype=torch.float32,
                        device="cpu").encode_planes(planes)
    enc = FrameEncoder("b16", params=params, cfg=cfg, compute_dtype=torch.float32,
                       mesh=cpu_mesh((4, 2), ("data", "model")))
    got = enc.encode_planes(planes)
    assert got.shape == want.shape == (8, 768)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3,
                               atol=2e-3)
    # 12 heads / model=2 -> 6 whole heads (384 rows) per q-projection shard,
    # and the MLP up-projection splits 3072 -> 1536.
    shards = [s for row in enc._shards for s in row]
    assert {tuple(s.params["layer.0.attention.q_proj.weight"].shape) for s in shards} == {(384, 768)}
    assert {tuple(s.params["layer.0.mlp.up_proj.weight"].shape) for s in shards} == {(1536, 768)}
    assert {tuple(s.params["layer.0.mlp.down_proj.weight"].shape) for s in shards} == {(768, 1536)}


def test_vitl_preset_param_pspecs_shard_shapes():
    """dinov3-vitl16 (1024 hidden, 16 heads of 64, 4096 intermediate) gets a
    model-axis split for every large projection on a (4, 2) mesh."""
    cfg = PRESETS["dinov3-vitl16"]
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size) == (1024, 16, 4096)
    D, I = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "layer.0.attention.q_proj.weight": (D, D),
        "layer.0.attention.q_proj.bias": (D,),
        "layer.0.attention.k_proj.weight": (D, D),
        "layer.0.attention.v_proj.weight": (D, D),
        "layer.0.attention.o_proj.weight": (D, D),
        "layer.0.mlp.up_proj.weight": (I, D),
        "layer.0.mlp.up_proj.bias": (I,),
        "layer.0.mlp.down_proj.weight": (D, I),
        "layer.0.norm1.weight": (D,),
        "patch_embed.weight": (D, 3, 16, 16),
    }
    params = {k: np.empty(s, np.float16) for k, s in shapes.items()}
    specs = vit_param_pspecs(params, cpu_mesh((4, 2), ("data", "model")), head_dim=cfg.head_dim)
    assert specs["layer.0.attention.q_proj.weight"] == ("model", None)
    assert specs["layer.0.attention.q_proj.bias"] == ("model",)
    assert specs["layer.0.attention.k_proj.weight"] == ("model", None)
    assert specs["layer.0.attention.v_proj.weight"] == ("model", None)
    assert specs["layer.0.attention.o_proj.weight"] == (None, "model")
    assert specs["layer.0.mlp.up_proj.weight"] == ("model", None)
    assert specs["layer.0.mlp.up_proj.bias"] == ("model",)
    assert specs["layer.0.mlp.down_proj.weight"] == (None, "model")
    assert specs["layer.0.norm1.weight"] == ()
    assert specs["patch_embed.weight"] == ()
    shards = shard_vit_params(params, specs, 2)
    assert shards[1]["layer.0.attention.o_proj.weight"].shape == (D, D // 2)
    assert shards[1]["layer.0.attention.o_proj.weight"].flags["C_CONTIGUOUS"]
    assert shards[0]["layer.0.norm1.weight"] is params["layer.0.norm1.weight"]


def test_param_pspecs_match_jax():
    """The port's rules give the JAX package's spec for every parameter of
    two presets on a (4, 2) mesh, the replicate fallback at 3 heads too."""
    from cbas_tpu.parallel.tp import vit_param_pspecs as jax_pspecs

    jmesh = jax_make_mesh((4, 2), ("data", "model"))
    for cfg in (PRESETS["dinov3-vitb16"], PRESETS["dinov2-with-registers-base"], SMALL_CFG, ViTConfig(
                    variant="dinov3", hidden_size=96, num_layers=1, num_heads=3, patch_size=16,
                    num_register_tokens=4, intermediate_size=96, layer_norm_eps=1e-5)):
        shapes = {k: np.empty(s, np.float16) for k, (s, _) in tvit.vit_param_shapes(cfg).items()}
        got = vit_param_pspecs(shapes, cpu_mesh((4, 2), ("data", "model")), cfg.head_dim)
        want = jax_pspecs(shapes, jmesh, head_dim=cfg.head_dim)
        assert got == {k: tuple(v) for k, v in want.items()}


def test_dp_tp_encode_matches_jax_mesh():
    """The port's (data=4, model=2) encode against ``cbas_tpu``'s FrameEncoder
    over JAX's 8 CPU devices in the same layout, same numpy weights: within
    one fp16 ulp (+1e-6), the bound ``tests/test_torch_encoder.py`` holds
    the one-device encoders to."""
    assert len(jax.devices()) == 8
    for cfg in (SMALL_CFG, ViTConfig(
            variant="dinov3", hidden_size=256, num_layers=2, num_heads=4, patch_size=16,
            num_register_tokens=4, intermediate_size=512, layer_norm_eps=1e-5)):
        params = init_vit_params(31, cfg)
        planes = np.random.default_rng(32).integers(0, 256, (9, RES, RES), np.uint8)
        ours = FrameEncoder("x", params=params, cfg=cfg, compute_dtype=torch.float32,
                            mesh=cpu_mesh((4, 2), ("data", "model"))).encode_planes(planes)
        ref = JaxFrameEncoder("x", params=params, cfg=jvit.ViTConfig(**vars(cfg)),
                              compute_dtype=jnp.float32,
                              mesh=jax_make_mesh((4, 2), ("data", "model"))).encode_planes(planes)
        assert_within_fp16_ulp(ours, np.asarray(ref))


@pytest.mark.parametrize("two_pass", ["", "1"])
def test_ln_two_pass_switch_matches_jax(two_pass, monkeypatch):
    """``CBAS_LN_TWO_PASS`` picks the same LayerNorm in both packages. On bf16
    rows with a large mean the single-pass variance (E[x^2] - mean^2 in
    fp32) loses digits; set, the switch gives the two-pass variance, the
    fp32 input's form bit for bit. Each package agrees with the other
    either way, within two bf16 ulps of the output (each rounds its fp32
    result once)."""
    monkeypatch.setenv("CBAS_LN_TWO_PASS", two_pass)
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((4, 7, 64)) + 300.0).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    params = {"n.weight": torch.from_numpy(w), "n.bias": torch.from_numpy(b)}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tvit._ln(params, "n", xt, 1e-6)
    want = np.asarray(jvit._ln({"n.weight": jnp.asarray(w), "n.bias": jnp.asarray(b)}, "n",
                               jnp.asarray(x).astype(jnp.bfloat16), 1e-6).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -6, atol=1e-3)
    two = tvit._ln(params, "n", xt.float(), 1e-6).to(torch.bfloat16)  # fp32 input: two-pass
    assert torch.equal(got, two) == bool(two_pass)


def test_encode_file_reuse_gated_dp_matches_single_device(video_path, mesh):
    """The reuse-gated path through a DP mesh: compacted key batches go
    through the sharded forward and the H5 matches row for row."""
    params = init_vit_params(0, SMALL_CFG)
    enc_1 = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                         device="cpu")
    enc_dp = FrameEncoder("e", params=params, cfg=SMALL_CFG, compute_dtype=torch.float32,
                          mesh=mesh)
    cfg = EncodeConfig(chunk_frames=40, reuse_threshold=6.0, reuse_tile=32)
    out = encode_file(enc_1, video_path, config=cfg)
    single = hdf5_store().read_all(out)
    os.remove(out)
    out = encode_file(enc_dp, video_path, config=cfg)
    dp = hdf5_store().read_all(out)
    os.remove(out)
    assert dp.shape == single.shape == (90, 64)
    assert_within_fp16_ulp(dp, single)  # the gate runs on the host: the same keys


def test_a_failing_shard_raises_in_the_caller_and_frees_the_others():
    """A shard's exception aborts the group's barrier, so the shards waiting
    on it wake up, and the first error is raised in the caller."""
    reduce = AllReduce([torch.device("cpu")] * 3)

    def shard(rank):
        if rank == 1:
            raise ValueError("shard 1 failed")
        return reduce(rank, torch.ones(2))

    t = threading.Timer(30.0, lambda: os._exit(3))  # a hang must not stall the suite
    t.start()
    try:
        with pytest.raises(ValueError, match="shard 1 failed"):
            run_shards([lambda r=r: shard(r) for r in range(3)], [torch.device("cpu")] * 3,
                       [reduce.barrier])
    finally:
        t.cancel()


def test_launch_counters_lose_no_update_under_shard_threads(monkeypatch):
    """The launch counters are module globals that every shard's thread
    updates: many threads, switching every microsecond, lose no count."""
    import sys

    from cbas_tpu_torch.ops import flash_attention as fa

    for name in ("launches", "launches_packed", "launches_headmajor", "launches_sm90"):
        monkeypatch.setattr(fa, name, 0)
    monkeypatch.setattr(fa, "launches_headmajor_by_dim", {})
    monkeypatch.setattr(fa, "launches_sm90_by_kernel", {})
    n_threads, n_each = 16, 500
    calls = (("attention_fat", 64, "sm90"), ("attention_packed", 64, "common"),
             ("attention_headmajor", 320, "common"))

    def work():
        for i in range(n_each):
            fa._count_launch(*calls[i % 3])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_each
    per = [sum(1 for i in range(n_each) if i % 3 == k) * n_threads for k in range(3)]
    assert (fa.launches, fa.launches_packed, fa.launches_headmajor) == tuple(per)
    assert fa.launches_headmajor_by_dim == {320: per[2]}
    assert fa.launches_sm90 == per[0] == fa.launches_sm90_by_kernel["attention_fat"]
    assert sum(per) == total


def test_all_reduce_sums_in_rank_order():
    reduce = AllReduce([torch.device("cpu")] * 4)
    parts = [torch.full((3,), float(10 ** r)) for r in range(4)]
    got = run_shards([lambda r=r: reduce(r, parts[r]) for r in range(4)],
                     [torch.device("cpu")] * 4, [reduce.barrier])
    for g in got:
        assert torch.equal(g, torch.full((3,), 1111.0))


def test_mesh_axes_and_padding():
    m = cpu_mesh((4, 2), ("data", "model"))
    assert isinstance(m, Mesh) and m.shape == {"data": 4, "model": 2} and m.devices.size == 8
    assert data_axis_size(m) == 4 and data_axis_size(None) == 1
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    assert m.grid().shape == (4, 2) and m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="axes other than"):
        make_mesh((2, 2), ("data", "seq"), ["cpu"] * 4).grid()


def test_chip_smoke_mesh_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 11 at a cut size: dinov3-vits16 over logical
    CPU shards in both layouts, a narrow ViT-7B stand-in over model = 2, the
    DP train step and DP inference, each against one device."""
    from cbas_tpu_torch.ops import flash_attention as fa

    torch.set_num_threads(2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "ENCODER", "dinov3-vits16")
    monkeypatch.setattr(chip_smoke, "VIT7B_CONFIG", {**chip_smoke.VIT7B_CONFIG, "hidden_size": 512,
                                                     "num_attention_heads": 4,
                                                     "intermediate_size": 512})
    monkeypatch.setattr(chip_smoke, "VIT7B_DEPTH", 2)
    monkeypatch.setattr(chip_smoke, "MESH_7B_FRAMES", 2)
    monkeypatch.setattr(chip_smoke, "MESH_TRAIN_FRAMES", 300)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 32)
    cfg = PRESETS["dinov3-vits16"]
    enc = FrameEncoder("dinov3-vits16", random_init=True, device="cpu")
    planes = np.random.default_rng(0).integers(0, 256, (4, 64, 64), np.uint8)
    hc = DeltasHeadConfig(in_features=cfg.hidden_size, out_features=2,
                          seq_len=chip_smoke.SEQ_LEN, lstm_hidden_size=8)
    bundle = ClassifierBundle(name="s", behaviors=["a", "b"], seq_len=chip_smoke.SEQ_LEN,
                              params=init_deltas_params(0, hc), lstm_hidden_size=8,
                              encoder_identifier="x")
    emb = np.random.default_rng(1).standard_normal((40, cfg.hidden_size)).astype(np.float16)
    half = chip_smoke.SEQ_LEN // 2
    probs = InferenceSession(bundle, device="cpu").predict_frames(emb, pad_front=half,
                                                                  pad_back=half)
    total, line = chip_smoke.mesh_phase(torch, fa, cfg, enc, planes, enc.encode_planes(planes),
                                        bundle, probs, emb, "cpu", device="cpu")
    assert line["ok"] and [(r["data"], r["model"]) for r in line["encode"]] == [(2, 2), (1, 4),
                                                                                (2, 2)]
    assert [r["kernel"] for r in line["encode"]] == ["attention_headmajor", "attention_fat",
                                                     "attention_headmajor"]
    assert line["train_step"]["loss_rel_err"] <= chip_smoke.STEP_LOSS_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kernel", [((2, 2), "attention_fat"),
                                           ((1, 4), "attention_headmajor")])
def test_mesh_encode_on_card_matches_one_device(layout, kernel):
    """Logical shards of cuda:0: the sharded encode in bf16 against the
    one-device encode, and each shard's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (run on the card)")
    from cbas_tpu_torch.ops import flash_attention as fa

    cfg = ViTConfig(variant="dinov3", hidden_size=768, num_layers=3, num_heads=12,
                    patch_size=16, num_register_tokens=4, intermediate_size=3072,
                    layer_norm_eps=1e-5)
    params = init_vit_params(41, cfg)
    planes = np.random.default_rng(42).integers(0, 256, (16, 256, 256), np.uint8)
    want = FrameEncoder("b", params=params, cfg=cfg, device="cuda").encode_planes(planes)
    d, m = layout
    enc = FrameEncoder("b", params=params, cfg=cfg,
                       mesh=make_mesh(layout, ("data", "model"), ["cuda:0"] * (d * m)))
    before = (fa.launches, fa.launches_headmajor)
    got = enc.encode_planes(planes)
    after = (fa.launches, fa.launches_headmajor)
    launched = after[kernel == "attention_headmajor"] - before[kernel == "attention_headmajor"]
    assert launched == (cfg.num_layers - 1) * d * m
    assert chip_smoke.row_cosine(got, want).min() >= chip_smoke.MESH_MIN_COS
