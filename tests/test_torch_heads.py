"""cbas_tpu_torch's classify path against the JAX package's on the CPU.

One param set from the JAX package's own init goes through both heads (in
the port via ``deltas_params_from_numpy``); inputs come from a numpy seed.
Tolerance 2e-5 in fp32 for the ops and the head, and 1e-5 for the written
probabilities (softmax outputs in [0, 1]): both sides compute in fp32 and
differ only in summation order.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from cbas_tpu.core import hdf5_store
from cbas_tpu.core.config import InferenceConfig
from cbas_tpu.engine.classifier import ClassifierBundle as JaxBundle
from cbas_tpu.engine.infer import InferenceSession as JaxSession
from cbas_tpu.models import heads as jheads
from cbas_tpu.models.lstm import init_lstm_params as jax_init_lstm, lstm_forward as jax_lstm
from cbas_tpu.ops import ema as jema
from cbas_tpu_torch.engine.classifier import ClassifierBundle
from cbas_tpu_torch.engine.infer import InferenceSession, infer_file
from cbas_tpu_torch.models import heads as theads
from cbas_tpu_torch.models.convert import deltas_params_from_numpy
from cbas_tpu_torch.models.lstm import init_lstm_params, lstm_forward, make_lstm
from cbas_tpu_torch.ops import ema as tema

TOL = 2e-5
D = 64


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("T", [31, 7, 2, 1])
def test_ema_and_robust_deltas_match_jax(T):
    x = np.random.default_rng(0).standard_normal((3, T, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tema.ema_smooth(torch.from_numpy(x), 0.3).numpy(),
        np.asarray(jax.jit(lambda a: jema.ema_smooth(a, 0.3))(x)), atol=TOL, rtol=TOL,
    )
    for got, want in zip(tema.robust_deltas(torch.from_numpy(x), 0.3),
                         jax.jit(lambda a: jema.robust_deltas(a, 0.3))(x)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_matches_jax(layers):
    params = jax.device_get(jax_init_lstm(jax.random.key(2), 12, 16, layers))
    x = np.random.default_rng(1).standard_normal((2, 9, 12)).astype(np.float32)
    lstm = make_lstm(12, 16, layers)
    lstm.load_state_dict({k[len("lstm."):]: torch.from_numpy(np.array(v)) for k, v in params.items()})
    with torch.no_grad():
        got = lstm_forward(lstm, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda p, a: jax_lstm(p, a, 16, layers))(_j(params), x))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    ours = init_lstm_params(np.random.default_rng(0), 12, 16, layers)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in params.items()}


@pytest.mark.parametrize(
    "kw",
    [
        dict(seq_len=31),
        dict(seq_len=7, lstm_hidden_size=16, use_acceleration=False),
        dict(seq_len=3, lstm_hidden_size=16, lstm_layers=2, center_window_size=0),
    ],
    ids=["default", "no-acc", "two-layer"],
)
def test_deltas_forward_matches_jax(kw):
    jcfg = jheads.DeltasHeadConfig(in_features=D, out_features=3, **kw)
    tcfg = theads.DeltasHeadConfig(in_features=D, out_features=3, **kw)
    params = jax.device_get(jheads.init_deltas_params(jax.random.key(3), jcfg))
    x = np.random.default_rng(4).standard_normal((5, kw["seq_len"], D)).astype(np.float32)
    want_logits, want_latent = jax.jit(lambda p, a: jheads.deltas_forward(p, a, jcfg))(_j(params), x)
    head = deltas_params_from_numpy(params, tcfg)
    with torch.no_grad():
        logits, latent = theads.deltas_forward(head, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent), atol=TOL, rtol=TOL)
    assert theads.infer_deltas_hparams(params) == jheads.infer_deltas_hparams(params)


def test_init_deltas_params_has_jax_names_and_shapes():
    cfg = dict(in_features=D, out_features=2, lstm_hidden_size=16)
    ours = theads.init_deltas_params(0, theads.DeltasHeadConfig(**cfg))
    ref = jax.device_get(jheads.init_deltas_params(jax.random.key(0), jheads.DeltasHeadConfig(**cfg)))
    assert {k: np.shape(v) for k, v in ours.items()} == {k: np.shape(v) for k, v in ref.items()}


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    cfg = theads.DeltasHeadConfig(in_features=D, out_features=3, seq_len=7, lstm_hidden_size=16)
    b = ClassifierBundle(
        name="testmodel", behaviors=["walk", "rest", "groom"], seq_len=7,
        params=theads.init_deltas_params(5, cfg), lstm_hidden_size=16,
        temperature=1.37, encoder_identifier="test-enc",
    )
    d = str(tmp_path_factory.mktemp("models") / "testmodel")
    b.save(d)
    return d


def test_bundle_roundtrip_and_guard(bundle_dir, tmp_path):
    b = ClassifierBundle.load(bundle_dir)
    assert (b.behaviors, b.seq_len, b.lstm_hidden_size, b.lstm_layers) == (
        ["walk", "rest", "groom"], 7, 16, 1)
    assert b.temperature == pytest.approx(1.37) and b.use_acceleration
    assert sorted(os.listdir(bundle_dir)) == [
        "config.yaml", "model.npz", "model.pth", "model_meta.json"]
    # the JAX package reads the port's bundle, and the other way round
    j = JaxBundle.load(bundle_dir)
    assert j.meta == b.meta and j.params.keys() == b.params.keys()
    d = str(tmp_path / "from_jax")
    j.save(d)
    again = ClassifierBundle.load(d)
    for k in b.params:
        np.testing.assert_array_equal(again.params[k], b.params[k])
    with pytest.raises(ValueError, match="Encoder mismatch"):
        ClassifierBundle.load(d, expected_encoder="some-other-encoder")
    # hyperparameters come from weight shapes when the metadata lacks them
    meta_path = os.path.join(d, "model_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["hyperparameters"]["lstm_hidden_size"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert ClassifierBundle.load(d).lstm_hidden_size == 16


def _legacy_params(seed=0, in_features=D, out_features=3, lstm_input=48):
    """A v2 head's numpy params (torch's own init) with non-trivial
    BatchNorm running statistics."""
    torch.manual_seed(seed)
    cfg = theads.LegacyHeadConfig(in_features=in_features, out_features=out_features,
                                  lstm_input=lstm_input)
    sd = theads.LegacyHead(cfg).state_dict()
    rng = np.random.default_rng(seed)
    sd["batch_norm.running_mean"] = torch.from_numpy(rng.uniform(-0.2, 0.2, in_features))
    sd["batch_norm.running_var"] = torch.from_numpy(rng.uniform(0.8, 1.2, in_features))
    sd["batch_norm.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, in_features))
    return {k: v.numpy().astype(np.float32) for k, v in sd.items() if "num_batches" not in k}


def test_legacy_bundle_does_not_run_yet(bundle_dir):
    """A legacy head runs for inference only: in training mode it raises, as
    the JAX package's ``legacy_forward(train=True)`` does."""
    b = ClassifierBundle(name="legacy", behaviors=["walk", "rest", "groom"], seq_len=7,
                         params=_legacy_params(), architecture="ClassifierLegacyLSTM")
    head = b.head()
    assert isinstance(head, theads.LegacyHead) and not head.training
    with pytest.raises(NotImplementedError, match="legacy"):
        head.train()(torch.zeros(2, 7, D))


@pytest.mark.parametrize("seq_len", [31, 7])
def test_legacy_forward_matches_jax(seq_len):
    params = _legacy_params(seed=1)
    x = np.random.default_rng(2).standard_normal((5, seq_len, D)).astype(np.float32)
    jcfg = jheads.LegacyHeadConfig(in_features=D, out_features=3, seq_len=seq_len)
    want = jax.jit(lambda p, a: jheads.legacy_forward_nodrop(p, a, jcfg))(_j(params), x)
    want_parts = jax.jit(lambda p, a: jheads.legacy_forward(p, a, jcfg))(_j(params), x)
    head = theads.LegacyHead(theads.LegacyHeadConfig(
        in_features=D, out_features=3, seq_len=seq_len, lstm_input=48))
    from cbas_tpu_torch.models.convert import legacy_params_from_numpy

    head = legacy_params_from_numpy(params, head.cfg)
    with torch.no_grad():
        got = theads.legacy_forward_nodrop(head, torch.from_numpy(x))
        parts = theads.legacy_forward(head, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for a, b in zip(parts, want_parts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_legacy_bundle_loads_and_runs(tmp_path):
    """A v2 bundle as the reference left it (model.pth + config.yaml, no
    model_meta.json) loads through ClassifierBundle.load and runs in
    InferenceSession, with the JAX package's probabilities."""
    from cbas_tpu.core.config import dump_yaml
    from cbas_tpu.models.torch_port import save_pth

    d = str(tmp_path / "JonesLabModel")
    os.makedirs(d)
    save_pth(_legacy_params(seed=3), os.path.join(d, "model.pth"))
    dump_yaml({"name": "JonesLabModel", "behaviors": ["walk", "rest", "groom"], "seq_len": 7},
              os.path.join(d, "config.yaml"))
    b = ClassifierBundle.load(d)
    assert b.architecture == "ClassifierLegacyLSTM" and b.behaviors == ["walk", "rest", "groom"]
    features = np.random.default_rng(4).standard_normal((40, D)).astype(np.float16)
    got = InferenceSession(b, device="cpu").predict_frames(features, 3, 3)
    want = JaxSession(JaxBundle.load(d)).predict_frames(features, 3, 3)
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("total", [130, 40, 3])
def test_infer_h5_csv_matches_jax(bundle_dir, tmp_path, total):
    features = np.random.default_rng(6).standard_normal((total, D)).astype(np.float16)
    h5 = str(tmp_path / f"v{total}_cls.h5")
    with hdf5_store.EmbeddingWriter(h5, encoder_identifier="test-enc", embed_dim=D) as w:
        w.append(features)
    # small chunks and window batches exercise halo reads and clamped batches
    cfg = InferenceConfig(chunk_frames=50, window_batch=32)
    got_csv = infer_file(h5, ClassifierBundle.load(bundle_dir), config=cfg, device="cpu")
    want_csv = JaxSession(JaxBundle.load(bundle_dir), cfg).infer_h5(
        h5, output_csv=str(tmp_path / "jax.csv"))
    assert got_csv.endswith(f"v{total}_testmodel_outputs.csv")
    got, want = pd.read_csv(got_csv), pd.read_csv(want_csv)
    assert list(got.columns) == list(want.columns) == ["walk", "rest", "groom"]
    assert got.shape == want.shape == (total, 3)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), atol=1e-5, rtol=0)


def test_predict_frames_short_and_bucketed(bundle_dir):
    session = InferenceSession(ClassifierBundle.load(bundle_dir), device="cpu")
    halo = 2 * (7 // 2)
    assert session._bucket_rows(3) == 512 + halo
    assert session._bucket_rows(513) == 1024 + halo
    assert session.predict_frames(np.zeros((4, D), np.float16), 0, 0).shape == (0, 3)
    probs = session.predict_frames(np.ones((10, D), np.float16), 3, 3)
    assert probs.shape == (10, 3)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-6)
