"""cbas_tpu_torch's head training against the JAX package's on the CPU.

Small widths (in_features 32, bottleneck 16, LSTM hidden 8, seq_len 7); the
same numpy params (the JAX package's init, loaded into the port with
``deltas_params_from_numpy``) and the same numpy batches go through both.
Tolerances, each with its reason:

- losses 1e-5 relative: fp32 on both sides, summation order only;
- gradients 1e-5 of each tensor's largest |g| plus 1e-9: the same, through
  a backward pass (JAX's scan LSTM against torch's);
- Adam trajectories: each step moves a weight by Adam's update of its own
  gradient, which is within 2e-5 relative of JAX's; weights agree to 1e-6
  absolute plus lr times the gradient difference over (min |g| + eps), the
  most Adam's first steps can amplify it.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from cbas_tpu.core import hdf5_store
from cbas_tpu.core.config import TrainingConfig
from cbas_tpu.core.project import Project
from cbas_tpu.engine import calibrate as jcal
from cbas_tpu.engine import data as jdata
from cbas_tpu.engine import train as jtrain
from cbas_tpu.engine.classifier import ClassifierBundle as JaxBundle
from cbas_tpu.models import heads as jheads
from cbas_tpu.utils.naming import h5_path_for_video
from cbas_tpu_torch.engine import calibrate as tcal
from cbas_tpu_torch.engine import data as tdata
from cbas_tpu_torch.engine import train as ttrain
from cbas_tpu_torch.engine.classifier import ClassifierBundle
from cbas_tpu_torch.engine.infer import InferenceSession
from cbas_tpu_torch.engine.metrics import f1_of
from cbas_tpu_torch.engine.orchestrator import run_training_job
from cbas_tpu_torch.models import heads as theads
from cbas_tpu_torch.models.convert import deltas_params_from_numpy
from tests.test_torch_data import DIM, make_labeled_project

SEQ = 7
SMALL = dict(in_features=DIM, out_features=3, seq_len=SEQ, bottleneck_dim=16, lstm_hidden_size=8)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-9
HEAD_TOL = 2e-5  # logits of the two heads (tests/test_torch_heads.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These steps are tiny: one intra-op thread runs them fastest, and keeps
    them from competing for cores with test workers running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _small_params(seed=3):
    cfg = jheads.DeltasHeadConfig(**SMALL)
    return jax.device_get(jheads.init_deltas_params(jax.random.key(seed), cfg))


def _batch(B=24, seed=4, masked=(3, 17)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, SEQ, DIM)).astype(np.float32)
    y = rng.integers(0, 3, B).astype(np.int32)
    y[list(masked)] = -1
    return x, y


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_weights", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", ["none", "some", "all"])
def test_masked_cross_entropy_matches_jax(use_weights, smoothing, masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 16).astype(np.int32)
    labels[{"none": [], "some": [1, 4, 9], "all": slice(None)}[masked]] = -1
    weights = rng.uniform(0.5, 2.0, 5).astype(np.float32) if use_weights else None
    got = ttrain.masked_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(weights) if use_weights else None, smoothing,
    )
    want = jtrain.masked_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        jnp.asarray(weights) if use_weights else None, smoothing,
    )
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL, abs=1e-12)
    if masked == "all":
        assert float(got) == 0.0


@pytest.mark.parametrize("n_valid", [0, 1, 2, 32])
def test_covariance_loss_matches_jax(n_valid):
    rng = np.random.default_rng(2)
    latent = rng.normal(size=(36, 12)).astype(np.float32)
    latent[n_valid:] = 1e6  # masked rows must not count
    valid = np.arange(36) < n_valid
    got = ttrain.covariance_loss(torch.from_numpy(latent), torch.from_numpy(valid))
    want = jtrain.covariance_loss(jnp.asarray(latent), jnp.asarray(valid))
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL, abs=1e-12)
    assert (float(got) == 0.0) == (n_valid < 2)


# ---------------------------------------------------------------------------
# One step and a trajectory against JAX
# ---------------------------------------------------------------------------

def _jax_loss(cfg, cw, smoothing):
    def loss_fn(p, x, y):
        logits, latent = jheads.deltas_forward(p, x, cfg, train=True, rng=None)
        ce = jtrain.masked_cross_entropy(logits, y, cw, smoothing)
        return ce + jtrain.covariance_loss(latent, y >= 0)

    return loss_fn


def _store_for(x):
    """A device store whose centre rows i*SEQ+SEQ//2 hold window i of x."""
    feats = x.reshape(-1, DIM).astype(np.float16)
    centers = (np.arange(len(x)) * SEQ + SEQ // 2).astype(np.int32)
    return feats, centers


@pytest.mark.parametrize("path", ["host", "gather"])
def test_one_step_loss_and_gradients_match_jax(path):
    params = _small_params()
    x, y = _batch()
    cw = np.array([0.5, 1.0, 2.0], np.float32)
    smoothing = 0.1
    jcfg = jheads.DeltasHeadConfig(**SMALL)
    feats, centers = _store_for(x)
    if path == "gather":
        x = feats.astype(np.float32).reshape(x.shape)  # the fp16-stored windows
    loss_w, grads_w = jax.jit(jax.value_and_grad(_jax_loss(jcfg, jnp.asarray(cw), smoothing)))(
        _jax_params(params), jnp.asarray(x), jnp.asarray(y)
    )

    head = deltas_params_from_numpy(params, theads.DeltasHeadConfig(**SMALL))
    opt = ttrain.make_optimizer(head, 1e-3, 0.0)
    if path == "host":
        step = ttrain.build_train_step(head, opt, cw, smoothing)
        loss = step(x, y)
    else:
        step = ttrain.build_train_step(head, opt, cw, smoothing, gather_seq_len=SEQ)
        loss = step(torch.from_numpy(feats), centers, y)
    assert head.training
    assert float(loss) == pytest.approx(float(loss_w), rel=LOSS_RTOL)
    named = dict(head.named_parameters())
    assert named.keys() == grads_w.keys()
    for name, p in named.items():
        want = np.asarray(grads_w[name])
        tol = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=tol, err_msg=name)


def test_three_adam_steps_match_jax_trajectory():
    params = _small_params(seed=5)
    jcfg = jheads.DeltasHeadConfig(**SMALL)
    lr, wd = 1e-3, 1e-2
    optimizer = jtrain.make_optimizer(lr, wd)
    jstep = jtrain.build_train_step(jcfg, optimizer, None, 0.0)
    jp = _jax_params(params)
    jopt = optimizer.init(jp)
    grad_fn = jax.jit(jax.grad(_jax_loss(jcfg, None, 0.0)))

    head = deltas_params_from_numpy(params, theads.DeltasHeadConfig(**SMALL))
    topt = ttrain.make_optimizer(head, lr, wd)
    assert [g["weight_decay"] for g in topt.param_groups] == [wd, 1e-3]
    assert [p is head.gate for p in topt.param_groups[1]["params"]] == [True]
    tstep = ttrain.build_train_step(head, topt, None, 0.0)
    for i in range(3):
        x, y = _batch(seed=10 + i)
        jgrads = grad_fn(jp, jnp.asarray(x), jnp.asarray(y))
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y), None)
        tloss = tstep(x, y)
        assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
        for name, p in head.named_parameters():
            g_t, g_j = p.grad.numpy(), np.asarray(jgrads[name])
            # The moments see (grad + decay * weight); the decayed term is
            # equal on both sides, so the gradient difference bounds theirs.
            amp = lr * np.abs(g_t - g_j) / (np.minimum(np.abs(g_t), np.abs(g_j)) + 1e-8)
            err = np.abs(p.detach().numpy() - np.asarray(jp[name]))
            assert (err <= 1e-6 + (i + 1) * amp).all(), (i, name, float(err.max()))


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def test_dropout_needs_train_mode_and_a_generator():
    head = deltas_params_from_numpy(_small_params(), theads.DeltasHeadConfig(**SMALL))
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        want = head(x)[0]
        head.train()
        np.testing.assert_array_equal(head(x)[0].numpy(), want.numpy())  # no generator
        got = [head(x, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
        head.eval()
        np.testing.assert_array_equal(head(x, torch.Generator().manual_seed(1))[0].numpy(),
                                      want.numpy())  # eval mode ignores it
    np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
    assert not torch.equal(got[0], got[2]) and not torch.equal(got[0], want)


@pytest.mark.parametrize("p", [0.1, 0.15, 0.5])
def test_dropout_rate_and_scaling(p):
    x = torch.full((400, 500), 3.0)
    g = torch.Generator().manual_seed(0)
    y = theads._dropout(x, p, True, g)
    kept = y != 0
    # 200k Bernoulli draws: the kept share is within 5 standard errors
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * (p * (1 - p) / x.numel()) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / (1 - p)))
    assert torch.equal(theads._dropout(x, p, True, None), x)
    assert torch.equal(theads._dropout(x, p, False, g), x)


def test_dropout_sites_in_the_head(monkeypatch):
    """Four draws (three bottlenecks, then lin0), at the JAX rates."""
    calls = []
    real = theads._dropout

    def spy(x, p, train, generator):
        calls.append((tuple(x.shape), p))
        return real(x, p, train, generator)

    monkeypatch.setattr(theads, "_dropout", spy)
    head = deltas_params_from_numpy(_small_params(), theads.DeltasHeadConfig(**SMALL)).train()
    head(torch.from_numpy(_batch(B=4, masked=())[0]), torch.Generator().manual_seed(0))
    assert calls == [((4, SEQ, 16), 0.1)] * 3 + [((4, SEQ, theads.LSTM_IN), 0.15)]


# ---------------------------------------------------------------------------
# train_head, cancel, resume, evaluation, calibration
# ---------------------------------------------------------------------------

@pytest.fixture
def labeled(tmp_path):
    root, instances, behaviors = make_labeled_project(tmp_path)

    def source(subjects, **kw):
        insts = [i for i in instances if any(f"/{s}/" in i["video"] for s in subjects)]
        return tdata.WindowSource(jdata.build_manifest(root, insts, SEQ, behaviors), SEQ, **kw)

    yield source, behaviors
    hdf5_store.global_handle_cache.close_all()


@pytest.mark.parametrize("device_data", [True, False], ids=["device-store", "host-windows"])
def test_train_head_learns_and_reports(labeled, device_data):
    source, behaviors = labeled
    messages = []
    params, reports, best_epoch = ttrain.train_head(
        source(["m0", "m1"]), source(["m2"]), SEQ, behaviors,
        batch_size=64, lr=5e-3, epochs=3, patience=3, lstm_hidden_size=16,
        progress_callback=messages.append, label_smoothing=0.1,
        device_data=device_data, device="cpu",
    )
    assert params is not None and best_epoch >= 0 and len(reports) <= 3
    assert all(isinstance(v, np.ndarray) for v in params.values())
    assert f1_of(reports[best_epoch].val_report, "weighted avg") > 0.95
    assert messages[:2] == ["Training Epoch 1/3...", messages[1]]
    assert messages[1].startswith("Epoch 1 Val F1: ")

    cfg = theads.DeltasHeadConfig(in_features=DIM, out_features=2, seq_len=SEQ, lstm_hidden_size=16)
    res = ttrain.evaluate_on_split(params, cfg, source(["m3"]), behaviors, batch_size=64, device="cpu")
    assert f1_of(res["report"], "weighted avg") > 0.95
    assert res["cm"].shape == (2, 2)


def test_train_cancel_returns_immediately(labeled):
    source, behaviors = labeled
    ev = threading.Event()
    ev.set()
    params, reports, best = ttrain.train_head(
        source(["m0"]), None, SEQ, behaviors, cancel_event=ev, epochs=5, batch_size=32,
        lstm_hidden_size=8, device="cpu",
    )
    assert params is None and reports == [] and best == -1


def test_train_without_validation_returns_last_epoch(labeled):
    source, behaviors = labeled
    params, reports, best = ttrain.train_head(
        source(["m0"]), None, SEQ, behaviors, epochs=2, batch_size=32, lstm_hidden_size=8,
        device="cpu",
    )
    assert params is not None and best == 1 and len(reports) == 2
    assert reports[1].train_report and not reports[1].val_report


def test_snapshot_does_not_follow_training():
    head = deltas_params_from_numpy(_small_params(), theads.DeltasHeadConfig(**SMALL))
    snap = ttrain._snapshot(head)
    ttrain.build_train_step(head, ttrain.make_optimizer(head, 1e-2, 0.0), None, 0.0)(*_batch())
    assert not torch.equal(snap["lin2.weight"], head.lin2.weight)


def test_state_roundtrip(tmp_path):
    cfg = theads.DeltasHeadConfig(**SMALL)
    head = deltas_params_from_numpy(theads.init_deltas_params(0, cfg), cfg)
    opt = ttrain.make_optimizer(head, 1e-3, 1e-4)
    step = ttrain.build_train_step(head, opt, None, 0.0)
    for i in range(2):
        step(*_batch(seed=i))
    best = theads.init_deltas_params(1, cfg)  # distinct best weights
    path = str(tmp_path / "state.npz")
    ttrain.save_train_state(path, head, opt, best,
                            {"epoch": 3, "best_f1": 0.5, "best_epoch": 2, "no_improve": 1})
    assert os.listdir(tmp_path) == ["state.npz"]  # staged and renamed

    head2 = deltas_params_from_numpy(theads.init_deltas_params(7, cfg), cfg)
    opt2 = ttrain.make_optimizer(head2, 1e-3, 1e-4)
    best2, meta = ttrain.load_train_state(path, head2, opt2)
    assert meta == {"epoch": 3, "best_f1": 0.5, "best_epoch": 2, "no_improve": 1}
    for k, v in head.state_dict().items():
        np.testing.assert_array_equal(head2.state_dict()[k].numpy(), v.numpy())
        np.testing.assert_array_equal(best2[k], best[k])
    p1, p2 = dict(head.named_parameters()), dict(head2.named_parameters())
    for name in p1:
        s1, s2 = opt.state[p1[name]], opt2.state[p2[name]]
        assert float(s2["step"]) == float(s1["step"]) == 2.0
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(s2[key].numpy(), s1[key].numpy())
    # Both continue identically from the restored state.
    x, y = _batch(seed=9)
    step(x, y)
    ttrain.build_train_step(head2, opt2, None, 0.0)(x, y)
    for k, v in head.state_dict().items():
        np.testing.assert_array_equal(head2.state_dict()[k].numpy(), v.numpy())


def test_resume_keeps_reports_aligned(labeled, tmp_path):
    source, behaviors = labeled
    src = source(["m0", "m1", "m2"])
    ckpt = str(tmp_path / "train_state.npz")
    kw = dict(batch_size=32, lr=5e-3, lstm_hidden_size=8, seed=3, checkpoint_path=ckpt,
              device="cpu")
    ttrain.train_head(src, src, SEQ, behaviors, epochs=2, patience=10, **kw)
    assert os.path.exists(ckpt)
    p2, r2, best2 = ttrain.train_head(src, src, SEQ, behaviors, epochs=4, patience=10,
                                      resume=True, **kw)
    assert p2 is not None and len(r2) == 4
    assert all(r.val_report for r in r2[2:])
    assert 0 <= best2 < len(r2) and r2[best2].val_report
    # An early-stopped checkpoint trains no further.
    _, r3, _ = ttrain.train_head(src, src, SEQ, behaviors, epochs=6, patience=0,
                                 resume=True, **kw)
    assert len(r3) == 4


def test_fit_temperature_matches_jax(labeled):
    source, behaviors = labeled
    params = jax.device_get(jheads.init_deltas_params(
        jax.random.key(0), jheads.DeltasHeadConfig(in_features=DIM, out_features=2, seq_len=SEQ,
                                                    lstm_hidden_size=8)))
    params["lin1.weight"] = params["lin1.weight"] * 3  # a confident, miscalibrated head
    cfg = theads.DeltasHeadConfig(in_features=DIM, out_features=2, seq_len=SEQ, lstm_hidden_size=8)
    val = source(["m2", "m3"])
    jval = jdata.WindowSource(val.manifest, SEQ)
    got = tcal.fit_temperature(params, cfg, val, batch_size=64, device="cpu")
    want = jcal.fit_temperature(params, jheads.DeltasHeadConfig(
        in_features=DIM, out_features=2, seq_len=SEQ, lstm_hidden_size=8), jval, batch_size=64)
    assert got != 1.0 and got == pytest.approx(want, abs=1e-4)
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, (300, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 300)
    assert tcal.fit_temperature_from_logits(logits, labels) == \
        jcal.fit_temperature_from_logits(logits, labels)
    assert tcal.fit_temperature(params, cfg, None, device="cpu") == 1.0


def test_mesh_is_refused():
    head = deltas_params_from_numpy(_small_params(), theads.DeltasHeadConfig(**SMALL))
    with pytest.raises(NotImplementedError, match="mesh"):
        ttrain.build_train_step(head, ttrain.make_optimizer(head, 1e-3, 0.0), None, 0.0,
                                mesh=object())


# ---------------------------------------------------------------------------
# The training job and bundles in both directions
# ---------------------------------------------------------------------------

FRAMES = 160


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    proj = Project.create_project(str(tmp_path_factory.mktemp("proj")), "p")
    rng = np.random.default_rng(0)
    ds = proj.create_dataset("behav", ["walk", "rest"], [])
    labels = {"walk": [], "rest": []}
    for s in range(8):
        rec_dir = os.path.join(proj.recordings_dir, "sess", f"m{s}")
        os.makedirs(rec_dir)
        video = os.path.join(rec_dir, f"m{s}_00001.mp4")
        open(video, "wb").close()
        feats = np.concatenate([rng.normal(2.0, 1.0, (FRAMES // 2, DIM)),
                                rng.normal(-2.0, 1.0, (FRAMES // 2, DIM))]).astype(np.float16)
        with hdf5_store.EmbeddingWriter(h5_path_for_video(video), embed_dim=DIM,
                                        encoder_identifier=proj.encoder_model_identifier) as w:
            w.append(feats)
        rel = os.path.relpath(video, proj.path)
        labels["walk"].append({"video": rel, "start": 10, "end": 60, "label": "walk"})
        labels["rest"].append({"video": rel, "start": 90, "end": 130, "label": "rest"})
    ds.labels["labels"] = labels
    ds.save_labels()
    proj.reload()
    yield proj
    hdf5_store.global_handle_cache.close_all()


def test_run_training_job_writes_a_bundle_the_jax_package_runs(project):
    task = TrainingConfig(
        name="behav", behaviors=["walk", "rest"], batch_size=64, learning_rate=5e-3,
        epochs=2, sequence_length=SEQ, training_method="weighted_loss", patience=3,
        num_runs=1, num_trials=1, use_test=True, test_split=0.2, lstm_hidden_size=16,
    )
    messages = []
    model_dir = run_training_job(project, task, progress_callback=messages.append, seed=11,
                                 device="cpu")
    assert model_dir == os.path.join(project.models_dir, "behav_model")
    assert "Run 1/1, Trial 1/1..." in messages
    for f in ("model.npz", "model.pth", "config.yaml", "model_meta.json"):
        assert os.path.exists(os.path.join(model_dir, f)), f
    ds_dir = project.datasets["behav"].path
    for f in ("performance_report.yaml", "confusion_matrix_validation_BEST.png",
              "f1-score_epochs_plot.png"):
        assert os.path.exists(os.path.join(ds_dir, f)), f
    with open(os.path.join(ds_dir, "performance_report.yaml")) as f:
        report = yaml.safe_load(f)
    assert report["run_results"][0]["validation_report"]
    assert report["training_parameters"]["temperature"] > 0
    assert set(report["reproducibility_info"]["library_versions"]) == {"torch", "numpy"}
    with open(os.path.join(ds_dir, "config.yaml")) as f:
        card = yaml.safe_load(f)
    assert card["state"] == "trained" and card["trained_model"] == "behav_model"

    ours = ClassifierBundle.load(model_dir, expected_encoder=project.encoder_model_identifier)
    theirs = JaxBundle.load(model_dir, expected_encoder=project.encoder_model_identifier)
    assert theirs.meta == ours.meta and theirs.temperature == ours.temperature
    x = np.random.default_rng(1).normal(0, 2, (40, SEQ, DIM)).astype(np.float32)
    with torch.no_grad():
        got = ours.logits_fn("cpu")(torch.from_numpy(x)).numpy()
    want = np.asarray(theirs.logits_fn()(theirs.jax_params(), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=HEAD_TOL, rtol=HEAD_TOL)

    # The learned model separates the two halves of a recording.
    h5 = project.recordings["sess"]["m0"].encoding_files[0]
    df = pd.read_csv(InferenceSession(ours, device="cpu").infer_h5(h5))
    assert len(df) == FRAMES
    assert df.iloc[20:60]["walk"].mean() > 0.8 and df.iloc[100:140]["rest"].mean() > 0.8


def test_chip_smoke_files_phase_runs_on_cpu():
    """chip_smoke.py's files phase, which the card's host skips for want of
    h5py, on the CPU with a narrow encoder: encode two clips, infer, run the
    training job on them and infer with the bundle it wrote."""
    import chip_smoke
    from cbas_tpu_torch.models.encoder import FrameEncoder
    from cbas_tpu_torch.models.vit import ViTConfig

    cfg = ViTConfig(variant="dinov3", hidden_size=64, num_layers=2, num_heads=2,
                    intermediate_size=128, layer_norm_eps=1e-5)
    enc = FrameEncoder("dinov3-vitb16", cfg=cfg, random_init=True, device="cpu")
    hc = theads.DeltasHeadConfig(in_features=64, out_features=2, seq_len=31, lstm_hidden_size=8)
    bundle = ClassifierBundle(name="m", behaviors=["a", "b"], seq_len=31,
                              params=theads.init_deltas_params(0, hc), lstm_hidden_size=8)
    line = chip_smoke.files_phase(enc, bundle, device="cpu")
    assert line["ok"] and line["frames"] == 200 and line["trained_bundle"] == "smoke_model"
    hdf5_store.global_handle_cache.close_all()


def test_chip_smoke_train_phase_runs_on_cpu(monkeypatch):
    """chip_smoke.py's train phase on the CPU, cut to 4 recordings of 600
    frames at width 32: every check it makes on the card passes here."""
    import chip_smoke

    cut = dict(TRAIN_RECORDINGS=4, TRAIN_VAL_RECORDINGS=1, TRAIN_FRAMES=600,
               TRAIN_LABELLED=300, TRAIN_BATCH=64, TRAIN_TIMED_STEPS=3,
               TRAIN_CLASS_SPREAD=1.0, TRAIN_LR=5e-3, HIDDEN=8)
    for name, value in cut.items():
        monkeypatch.setattr(chip_smoke, name, value)
    line = chip_smoke.train_phase(torch, "cpu", (False, False), dim=DIM, device="cpu")
    assert line["ok"] and line["train_centres"] == 900 and line["val_centres"] == 300
    assert line["store_bytes_on_device"] <= 4 * 600 * DIM * 2 and len(line["epoch_s"]) == 3


def test_jax_trained_bundle_runs_in_the_port(project, tmp_path):
    behaviors = ["walk", "rest"]
    insts = project.datasets["behav"].all_instances()
    manifest = jdata.build_manifest(project.path, insts, SEQ, behaviors)
    params, _, best = jtrain.train_head(jdata.WindowSource(manifest, SEQ), None, SEQ, behaviors,
                                        batch_size=64, lr=5e-3, epochs=1, lstm_hidden_size=8)
    assert best == 0
    d = str(tmp_path / "jax_model")
    JaxBundle(name="jax_model", behaviors=behaviors, seq_len=SEQ, params=params,
              lstm_hidden_size=8, temperature=1.3).save(d)
    ours = ClassifierBundle.load(d)
    assert (ours.lstm_hidden_size, ours.temperature) == (8, 1.3)
    h5 = project.recordings["sess"]["m1"].encoding_files[0]
    got = pd.read_csv(InferenceSession(ours, device="cpu").infer_h5(h5, str(tmp_path / "t.csv")))
    from cbas_tpu.engine.infer import InferenceSession as JaxSession

    want = pd.read_csv(JaxSession(JaxBundle.load(d)).infer_h5(h5, str(tmp_path / "j.csv")))
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), atol=1e-5, rtol=0)
