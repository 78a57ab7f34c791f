"""cbas_tpu_torch's tools (``cbas_tpu_torch/tools/``) and
``models/vit.py::cls_attention_map`` against the JAX package's, on the CPU.

Weights come from the JAX package's own init, carried over as numpy through
``models/convert.py``; inputs come from a numpy seed. Each tool that uses a
device runs here with ``--device cpu`` (``--force-cpu`` for
``encode_fleet``); under its ``cuda`` default, with no card, it refuses
naming CUDA.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")
pd = pytest.importorskip("pandas")

import jax
import jax.numpy as jnp

import chip_smoke
from cbas_tpu.models import vit as jvit
from cbas_tpu_torch.models import vit as tvit
from cbas_tpu_torch.models.convert import vit_params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "examples", "demo_project")
DEMO_ENCODER = os.path.join(DEMO, "demo_encoder")
TOOLS = ("validate_kernels", "compare_encoders", "check_h5", "analyze_split",
         "prediction_viewer", "encode_fleet", "soak", "reuse_fidelity", "weak_scaling")
no_card = pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")

# cls_attention_map, fp32 on both sides: the map is a softmax of two layers'
# fp32 scores (summation order only), so its values agree to 1e-6 absolute
# and 1e-5 relative.
MAP_ATOL, MAP_RTOL = 1e-6, 1e-5


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"  # two workers at a time: more threads only contend
    return env


# ---------------------------------------------------------------------------
# cls_attention_map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dinov2", "dinov3"])
def test_cls_attention_map_matches_jax(variant):
    kw = dict(variant=variant, hidden_size=64, num_layers=2, num_heads=2, patch_size=16,
              num_register_tokens=4, intermediate_size=128,
              layer_norm_eps=1e-5 if variant == "dinov3" else 1e-6, image_size=32)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    params = jax.device_get(jvit.init_vit_params(jax.random.key(0), jcfg))
    # a 2x3 patch grid: dinov2 resamples its 2x2 position table to it
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 48)).astype(np.float32)
    want = np.asarray(jvit.cls_attention_map(params, jnp.asarray(x), jcfg))
    got = tvit.cls_attention_map(vit_params_from_numpy(params, tcfg), torch.from_numpy(x),
                                 tcfg).numpy()
    assert got.shape == want.shape == (2, 2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MAP_ATOL, rtol=MAP_RTOL)
    assert got.reshape(2, -1).sum(1).max() <= 1.0 + 1e-5  # mass over patches only


# ---------------------------------------------------------------------------
# validate_kernels
# ---------------------------------------------------------------------------

def test_validate_kernels_passes_on_tiny_geometries(capsys):
    from cbas_tpu_torch.tools.validate_kernels import main

    records = []
    rc = main(geometries=[(1, 2, 24, 8, True), (1, 2, 19, 64, False)], device="cpu",
              records=records)
    out = capsys.readouterr().out
    assert rc == 0 and "FAIL" not in out
    assert "packed vs fp64" in out and "fat vs fp64" in out  # K2's and K1's plain versions ran
    assert out.count("on fused q|k|v views vs fp64 ") == 3  # K1, K2 and K3 on views of one buffer
    assert len(records) == 10 and all(r["ok"] and r["err"] < r["tol"] for r in records)


def test_validate_kernels_detects_failure(capsys, monkeypatch):
    import cbas_tpu_torch.ops.flash_attention as fa
    from cbas_tpu_torch.tools.validate_kernels import main

    real = fa.fused_attention

    def broken(q, k, v, scale, *args, **kw):
        return real(q, k, v, scale * 1.5, *args, **kw)

    monkeypatch.setattr(fa, "fused_attention", broken)
    assert main(geometries=[(1, 2, 16, 8, False)], device="cpu") != 0
    assert "FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# check_h5, analyze_split, prediction_viewer: the JAX tools' output
# ---------------------------------------------------------------------------

def _run_both(tool, fn, capsys):
    """``fn(module)`` with the JAX tool and the port's: (result, stdout) each."""
    import importlib

    out = []
    for pkg in ("cbas_tpu", "cbas_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        result = fn(mod)
        out.append((result, capsys.readouterr().out))
    return out


def test_check_h5_equals_jax(tmp_path, capsys):
    from cbas_tpu_torch.core import hdf5_store

    good = str(tmp_path / "a_cls.h5")
    with hdf5_store.EmbeddingWriter(good, encoder_identifier="enc-a", embed_dim=32) as w:
        w.append(np.zeros((7, 32)))
    missing = str(tmp_path / "missing.h5")
    runs = [([good], 0), ([good, "--expect", "other"], 1), ([good, "--expect", "enc-a"], 0),
            ([missing], 1), ([good, missing], 1)]
    for argv, rc in runs:
        (j_rc, j_out), (t_rc, t_out) = _run_both("check_h5", lambda m: m.main(argv), capsys)
        assert t_rc == j_rc == rc and t_out == j_out, argv
    (j_info, _), (t_info, _) = _run_both("check_h5", lambda m: m.inspect(good, None), capsys)
    assert t_info == j_info and t_info["ok"] and t_info["frames"] == 7 and t_info["dim"] == 32


def test_analyze_split_equals_jax(tmp_path, capsys):
    from cbas_tpu_torch.core.project import Project

    proj = Project.create_project(str(tmp_path), "p")
    ds = proj.create_dataset("d", ["walk", "rest"], [])
    rng = np.random.default_rng(5)
    ds.labels["labels"]["walk"] = [
        {"video": f"recordings/s/m{i}/v.mp4", "start": int(s), "end": int(s) + 9, "label": "walk"}
        for i in range(7) for s in rng.integers(0, 500, 3)
    ]
    ds.labels["labels"]["rest"] = [
        {"video": f"recordings/s/m{i}/v.mp4", "start": 600, "end": 640, "label": "rest"}
        for i in range(7)
    ]
    ds.save_labels()
    argv = ["--project", proj.path, "--dataset", "d", "--seed", "42", "--runs", "2"]
    (_, j_out), (_, t_out) = _run_both("analyze_split", lambda m: m.main(argv), capsys)
    assert t_out == j_out
    assert "7 subjects" in t_out and "Run 1" in t_out and "rest" in t_out


def test_prediction_overlay_equals_jax(tmp_path, capsys):
    video = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 96))
    for i in range(20):
        w.write(np.full((96, 96, 3), i * 10, np.uint8))
    w.release()
    df = pd.DataFrame({"walk": np.linspace(0, 1, 20), "rest": np.linspace(1, 0, 20)})
    outs = {pkg: str(tmp_path / f"overlay_{pkg}.mp4") for pkg in ("cbas_tpu", "cbas_tpu_torch")}
    _run_both("prediction_viewer",
              lambda m: m.export_overlay(video, df, outs[m.__name__.split(".")[0]]), capsys)
    frames = {}
    for pkg, path in outs.items():
        cap = cv2.VideoCapture(path)
        frames[pkg] = []
        ok, f = cap.read()
        while ok:
            frames[pkg].append(f)
            ok, f = cap.read()
        cap.release()
    assert len(frames["cbas_tpu_torch"]) == len(frames["cbas_tpu"]) == 20
    assert all(np.array_equal(a, b) for a, b in zip(frames["cbas_tpu_torch"], frames["cbas_tpu"]))


# ---------------------------------------------------------------------------
# encode_fleet
# ---------------------------------------------------------------------------

def test_claim_is_exclusive_until_released(tmp_path):
    from cbas_tpu_torch.tools.encode_fleet import release_claim, try_claim

    video = str(tmp_path / "cam_00001.mp4")
    open(video, "w").close()
    assert try_claim(video, ttl_s=3600)
    assert not try_claim(video, ttl_s=3600)  # second claimer loses
    release_claim(video)
    assert try_claim(video, ttl_s=3600)  # released -> claimable again
    release_claim(video)


def test_stale_claim_is_broken(tmp_path):
    from cbas_tpu_torch.tools.encode_fleet import claim_path, release_claim, try_claim

    video = str(tmp_path / "cam_00001.mp4")
    open(video, "w").close()
    assert try_claim(video, ttl_s=3600)
    old = time.time() - 7200
    os.utime(claim_path(video), (old, old))  # crashed-worker leftover
    assert try_claim(video, ttl_s=3600)  # TTL elapsed -> broken and re-owned
    release_claim(video)


def test_claim_contention_exactly_one_winner(tmp_path):
    """N threads racing for the same claim: exactly one wins per round, even
    when rounds are interleaved with releases and stale-claim breaking."""
    from cbas_tpu_torch.utils.claims import release_claim_path, try_claim_path

    path = str(tmp_path / "work.claim")
    for round_no in range(20):
        wins = []
        barrier = threading.Barrier(8)

        def racer():
            barrier.wait()
            if try_claim_path(path, ttl_s=3600):
                wins.append(1)

        threads = [threading.Thread(target=racer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1, f"round {round_no}: {len(wins)} winners"
        if round_no % 2:
            release_claim_path(path)  # next round contends on a fresh file
        else:
            old = time.time() - 7200  # next round must break a stale claim
            os.utime(path, (old, old))
    assert [f for f in os.listdir(tmp_path) if f.endswith(".break")] == []


def test_claim_heartbeat_keeps_live_lease_from_aging_out(tmp_path):
    from cbas_tpu_torch.utils.claims import ClaimHeartbeat, try_claim_path

    claim = str(tmp_path / "out_cls.h5.claim")
    ttl = 0.6
    assert try_claim_path(claim, ttl_s=ttl)
    hb = ClaimHeartbeat(claim, ttl)
    hb.interval_s = 0.1  # the production floor is 5 s; tighten for the test
    with hb:
        time.sleep(2 * ttl)  # well past the TTL while the owner is alive
        assert not try_claim_path(claim, ttl_s=ttl)  # lease still held
    time.sleep(2 * ttl)  # heartbeat stopped: the lease may now age out
    assert try_claim_path(claim, ttl_s=ttl)


def _fleet(root, *args):
    """encode_fleet over the project at ``root``, its workers in the fleet
    step's environment (``chip_smoke.fleet_env``: FLEET_THREADS intra-op
    threads, MKL's and OpenMP's dynamic teams off, oneDNN's verbose lines
    on); the fleet's JSON records apart from those lines."""
    proc = subprocess.run(
        [sys.executable, "-m", "cbas_tpu_torch.tools.encode_fleet", "--project", root, *args],
        capture_output=True, text=True, timeout=600, env=chip_smoke.fleet_env(ROOT),
    )
    return proc, [json.loads(line) for line in proc.stdout.strip().splitlines()
                  if not line.startswith("onednn_verbose")]


def _onednn_matmul(tmp_path):
    """The oneDNN kernel this process runs a bf16 matmul with (its verbose
    line, which names the ISA: AMX and AVX-512 kernels round differently),
    read from the file descriptor oneDNN writes it to."""
    path = tmp_path / "onednn_verbose.txt"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    saved = os.dup(1)
    os.dup2(fd, 1)
    try:
        with torch.backends.mkldnn.verbose(torch.backends.mkldnn.VERBOSE_ON):
            a = torch.ones(64, 64, dtype=torch.bfloat16)
            a @ a
    finally:
        os.dup2(saved, 1)
        os.close(fd)
        os.close(saved)
    return [x for x in path.read_text().splitlines() if ",exec," in x][:1]


def _fleet_ok(proc, lines):
    """The fleet's exit code and the error lines its workers printed, with
    the end of its standard error, as an assertion's message."""
    errors = [line for line in lines if "error" in line]
    assert proc.returncode == 0 and not errors, (
        f"encode_fleet rc {proc.returncode}, worker errors {errors}, "
        f"stderr {proc.stderr[-4000:]}")


def test_two_cpu_workers_drain_the_demo_project(tmp_path):
    """Two --force-cpu workers drain a copy of the demo project through the
    claims; every H5 is stamped and bit-equal to an in-process encode_file
    (which tests/test_torch_encoder.py holds against the JAX package), and
    classify mode then gives every H5 its outputs CSV once."""
    from cbas_tpu_torch.core.project import Project
    from cbas_tpu_torch.engine.encode import encode_file
    from cbas_tpu_torch.models.encoder import FrameEncoder

    root = str(tmp_path / "demo")
    shutil.copytree(DEMO, root)
    proc, lines = _fleet(root, "--workers", "2", "--force-cpu", "--batch", "64")
    _fleet_ok(proc, lines)
    summary = lines[-1]
    assert summary["fleet_done"] and summary["workers"] == 2
    assert summary["videos"] == 8 and summary["still_stale"] == 0
    per_file = [line for line in lines if "h5" in line]
    tallies = [line for line in lines if "worker_done" in line]
    assert len(per_file) == 8 and all(line["fps"] > 0 for line in per_file)
    assert len(tallies) == 2 and sum(w["encoded"] for w in tallies) == 8
    assert sum(w["failed"] for w in tallies) == 0
    proj = Project(root)
    assert proj.stale_or_missing_embeddings() == []
    assert [f for _, _, fs in os.walk(root) for f in fs if f.endswith(".claim")] == []

    # the same encode in this process: the project's encode settings and
    # dtype, chunks of 64, held to the workers' settings (chip_smoke's
    # fleet_threads: their thread count, dynamic teams off; this process
    # keeps whatever earlier tests in it left, restored after)
    settings = proj.settings
    enc = FrameEncoder(proj.encoder_model_identifier, device="cpu",
                       compute_dtype=getattr(torch, settings.runtime.compute_dtype))
    cfg = dataclasses.replace(settings.encode, chunk_frames=64)
    inproc = tmp_path / "inproc"
    with chip_smoke.fleet_threads(torch) as pinned:
        for i, line in enumerate(per_file):
            video = str(inproc / f"v{i}" / os.path.basename(line["video"]))
            os.makedirs(os.path.dirname(video))
            shutil.copyfile(line["video"], video)
            with h5py.File(encode_file(enc, video, config=cfg), "r") as a, \
                    h5py.File(line["h5"], "r") as b:
                want, got = a["cls"][:], b["cls"][:]
                assert want.dtype == got.dtype and want.shape == got.shape
                if not np.array_equal(want, got):
                    by_row = np.abs(want.astype(np.float32) - got.astype(np.float32)).max(axis=1)
                    rows = np.flatnonzero(by_row)
                    pytest.fail(f"{line['h5']} differs from the in-process encode in "
                                f"{len(rows)} of {len(by_row)} rows, "
                                f"{rows[:20].tolist()} by up to {by_row[rows[:20]].tolist()} "
                                f"(largest |value| {float(np.abs(want).max())}); this "
                                f"process's bf16 matmul kernel {_onednn_matmul(tmp_path)}; "
                                f"the workers' oneDNN {chip_smoke.onednn_kernels(proc.stdout)}; "
                                f"its settings {pinned}; fleet lines {lines}")
                assert b.attrs["encoder_model_identifier"] == a.attrs["encoder_model_identifier"]

    proc, lines = _fleet(root, "--workers", "2", "--force-cpu", "--model", "demo_behaviors_model")
    _fleet_ok(proc, lines)
    assert lines[-1]["still_stale"] == 0
    csvs = [line for line in lines if "csv" in line]
    assert len(csvs) == 8 and all(os.path.exists(line["csv"]) for line in csvs)
    assert sum(w["classified"] for w in lines if "worker_done" in w) == 8
    assert [f for _, _, fs in os.walk(root) for f in fs
            if f.endswith((".claim", ".csv.tmp")) or f.startswith(".encode_fleet_")] == []


def test_fleet_workers_report_their_onednn_kernels():
    """The fleet's workers run with oneDNN's verbose lines on
    (``chip_smoke.fleet_env``), and ``chip_smoke.onednn_kernels`` reads the
    ISA and the matmul implementations from them: here from a process
    started in that environment, whose own bf16 matmul it names."""
    env = chip_smoke.fleet_env(ROOT)
    assert env["ONEDNN_VERBOSE"] == chip_smoke.FLEET_ONEDNN_VERBOSE
    proc = subprocess.run(
        [sys.executable, "-c", "import torch; a = torch.ones(64, 64, dtype=torch.bfloat16); "
                               "a @ a; print('{}')"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = chip_smoke.onednn_kernels(proc.stdout)
    assert got["isa"] and got["matmul"], proc.stdout[-2000:]
    assert [x for x in proc.stdout.splitlines() if not x.startswith("onednn_verbose")] == ["{}"]
    assert chip_smoke.onednn_kernels("{}\nnoise") == {"isa": [], "matmul": []}


def test_fleet_threads_pins_this_process_and_restores_it():
    """chip_smoke.fleet_threads finds the OpenMP runtime torch ships, turns
    its dynamic team off and holds FLEET_THREADS intra-op threads inside the
    block, says so in what it yields, and restores both after."""
    threads = torch.get_num_threads()
    omp = chip_smoke._omp_dynamic()
    assert omp is not None
    before = omp[0]()
    with chip_smoke.fleet_threads(torch) as pinned:
        assert torch.get_num_threads() == chip_smoke.FLEET_THREADS
        assert omp[0]() == 0
        assert os.environ["OMP_DYNAMIC"] == os.environ["MKL_DYNAMIC"] == "FALSE"
    assert pinned == {"threads": chip_smoke.FLEET_THREADS, "omp_runtime": omp[2],
                      "omp_dynamic_before": before, "omp_dynamic_inside": 0}
    assert torch.get_num_threads() == threads and omp[0]() == before


def test_chip_smoke_fleet_step_runs_on_cpu():
    """The chip run's fleet step (one worker over two 256x256 clips, H5s
    against an in-process encode), here with the demo encoder in fp32."""
    out = chip_smoke.fleet_step(device="cpu", encoder_dir=DEMO_ENCODER, dtype="float32")
    assert out["ok"] and out["summary"]["still_stale"] == 0
    assert out["max_abs_diff_vs_in_process"] == 0.0


# ---------------------------------------------------------------------------
# soak
# ---------------------------------------------------------------------------

def test_soak_tiny_sustained(tmp_path):
    """tests/test_soak.py's run and asserts, through the chip run's soak step."""
    r = chip_smoke.soak_step(device="cpu", minutes=0.3, segment_seconds=5, size=32, tiny=True,
                             project_dir=str(tmp_path))
    assert r["cameras"] == 2 and r["device"] == "cpu"
    assert r["segments_delivered"] >= 4          # feeder paced correctly
    assert r["segments_encoded"] >= 2            # H5s written via the workers
    assert r["segments_classified"] >= 1         # live chain produced CSVs
    assert r["actograms_generated"] >= 1         # visualize path ran in-loop
    assert r["sustained"], r["reason"]


# ---------------------------------------------------------------------------
# reuse_fidelity
# ---------------------------------------------------------------------------

def test_reuse_fidelity_matches_jax_reuse_count(tmp_path):
    """The JAX test's reduced fixture. The gate sees only frames, so the
    reuse share equals what the JAX package's reuse-gated encode_file counts
    on the same clip; agreement and cosine meet the JAX test's bounds."""
    from cbas_tpu.core.config import EncodeConfig
    from cbas_tpu.engine.encode import EncodeStats, encode_file
    from cbas_tpu.models.encoder import FrameEncoder
    from cbas_tpu.tools.reuse_fidelity import make_cage_clip
    from cbas_tpu_torch.tools.reuse_fidelity import run

    report = run([6.0], n_frames=300, size=64, seq_len=15, epochs=3, tiny=True, tiles=[32],
                 device="cpu")
    row = report["rows"][0]
    assert row["reuse_pct"] >= 60.0
    assert row["argmax_agreement_pct"] >= 99.0
    assert row["cosine_mean"] >= 0.999

    video = str(tmp_path / "cage_00001.mp4")
    make_cage_clip(video, n_frames=300, size=64)
    cfg = jvit.ViTConfig(variant="dinov3", hidden_size=64, num_layers=1, num_heads=2,
                         patch_size=16, num_register_tokens=4, intermediate_size=128,
                         layer_norm_eps=1e-5)
    enc = FrameEncoder("reuse-fid", params=jax.device_get(jvit.init_vit_params(
        jax.random.key(0), cfg)), cfg=cfg, compute_dtype=jnp.float32)
    st = EncodeStats()
    encode_file(enc, video, config=EncodeConfig(chunk_frames=64, reuse_threshold=6.0,
                                                reuse_tile=32), stats=st)
    assert st.key_frames + st.reused_frames == 300
    assert row["reuse_pct"] == round(100.0 * st.reused_frames / 300, 1)


# ---------------------------------------------------------------------------
# compare_encoders --checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from transformers.models.dinov3_vit.modeling_dinov3_vit import DINOv3ViTModel

    hf_cfg = transformers.DINOv3ViTConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2, patch_size=16,
        image_size=32, num_register_tokens=4, intermediate_size=256,
    )
    torch.manual_seed(0)
    d = str(tmp_path_factory.mktemp("ckpt") / "dinov3-tiny")
    DINOv3ViTModel(hf_cfg).eval().save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def frame_png(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("img") / "frame.png")
    cv2.imwrite(p, np.random.default_rng(3).integers(0, 256, (64, 64, 3), np.uint8))
    return p


def test_compare_encoders_checkpoint_passes(checkpoint_dir, frame_png, tmp_path, capsys):
    from cbas_tpu_torch.tools.compare_encoders import main

    out = str(tmp_path / "cmp.png")
    main(["--image", frame_png, "--checkpoint", checkpoint_dir, "--out", out, "--device", "cpu"])
    assert os.path.getsize(out) > 5000
    assert "ok at tol" in capsys.readouterr().out


def test_compare_encoders_checkpoint_fails_on_port_bug(checkpoint_dir, frame_png, tmp_path,
                                                       monkeypatch):
    """A weight perturbed on the port's side only (a port bug) fails the
    parity check: exit code 1."""
    import cbas_tpu_torch.models.encoder as enc_mod
    from cbas_tpu_torch.tools.compare_encoders import main

    real = enc_mod.load_encoder_params

    def buggy(identifier):
        params = dict(real(identifier))
        key = next(k for k in params if "attention" in k and k.endswith("weight"))
        params[key] = params[key] * 10.0
        return params

    monkeypatch.setattr(enc_mod, "load_encoder_params", buggy)
    with pytest.raises(SystemExit) as exc:
        main(["--image", frame_png, "--checkpoint", checkpoint_dir,
              "--out", str(tmp_path / "cmp2.png"), "--device", "cpu"])
    assert exc.value.code == 1


# ---------------------------------------------------------------------------
# weak_scaling
# ---------------------------------------------------------------------------

def test_weak_scaling_shape_2dev(capsys):
    """The DP encode's weak-scaling shape at 2 logical CPU shards, as the
    JAX suite's ``test_weak_scaling_shape_2dev``: one weak-scaled step costs
    about 2 single-device steps on shared cores, plus the split and the
    gather. A cost that grew with the work would land far above the bound.
    The cost is the process's CPU seconds a step (``cpu_step_s``), one
    intra-op thread a shard: on cores that the other test workers
    oversubscribe, the wall time of the 2-shard step also counted the
    scheduler's delays (each op's hand-over of the interpreter lock
    between the shards' threads, and with two intra-op threads each op's
    OpenMP team, waited for a core), which ran the step at 3.2-3.7x the
    single device's in two runs of this file on six workers. Then the
    report of ``main``."""
    from cbas_tpu_torch.tools.weak_scaling import main, measure

    threads = torch.get_num_threads()  # restored: later tests in this process keep theirs
    torch.set_num_threads(1)  # no OpenMP team spinning on CPU time it then waits out
    try:
        # Three reads of each, interleaved, and the cheapest of each kept: a
        # cost that grows with the work raises every read, the cheapest too.
        reads = [(measure(1, per_device_batch=16, iters=4, device="cpu"),
                  measure(2, per_device_batch=16, iters=4, device="cpu")) for _ in range(3)]
    finally:
        torch.set_num_threads(threads)
    r1, r2 = (min((pair[i] for pair in reads), key=lambda r: r["cpu_step_s"]) for i in (0, 1))
    assert (r1["batch"], r2["batch"]) == (16, 32)
    overhead = (r2["cpu_step_s"] - 2 * r1["cpu_step_s"]) / (2 * r1["cpu_step_s"])
    assert overhead < 0.6, f"2-shard weak-scaled step {r2} vs 1-device {r1}"
    assert main(["--devices", "1", "2", "--per-device-batch", "2", "--iters", "1",
                 "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert [r["devices"] for r in report["rows"]] == [1, 2]
    assert report["rows"][0]["overhead_pct"] == 0.0


# ---------------------------------------------------------------------------
# the device rule and the command lines
# ---------------------------------------------------------------------------

def _refusals(tmp_path):
    from cbas_tpu_torch.tools import (
        compare_encoders, reuse_fidelity, soak, validate_kernels, weak_scaling,
    )

    png = str(tmp_path / "f.png")
    cv2.imwrite(png, np.zeros((32, 32, 3), np.uint8))
    return {
        "validate_kernels": lambda: validate_kernels.main(geometries=[(1, 2, 16, 8, False)]),
        "compare_encoders": lambda: compare_encoders.main(
            ["--image", png, "--encoders", "dinov3-vits16", "--random-init"]),
        "soak": lambda: soak.run_soak(cameras=1, minutes=0.1, tiny=True,
                                      project_dir=str(tmp_path / "soak")),
        "reuse_fidelity": lambda: reuse_fidelity.run([6.0], n_frames=10, size=32, tiny=True),
        "weak_scaling": lambda: weak_scaling.main(["--devices", "1", "2"]),
    }


@no_card
@pytest.mark.parametrize("tool", ["validate_kernels", "compare_encoders", "soak",
                                  "reuse_fidelity", "weak_scaling"])
def test_tool_refuses_without_cuda(tool, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        _refusals(tmp_path)[tool]()
    assert not os.path.exists(tmp_path / "soak")  # refused before any work


@no_card
def test_encode_fleet_refuses_without_cuda(tmp_path):
    root = str(tmp_path / "demo")
    shutil.copytree(DEMO, root)
    proc, lines = _fleet(root, "--workers", "2")
    assert proc.returncode != 0 and "CUDA" in lines[-1]["error"]
    assert "worker_done" not in proc.stdout  # no worker started
    assert [f for f in os.listdir(root) if f.startswith(".encode_fleet_")] == []


def test_every_tool_runs_with_python_m():
    """``python -m cbas_tpu_torch.tools.<name> --help`` for each tool, in one
    interpreter where importing cbas_tpu raises."""
    from test_torch_imports import BLOCK_CBAS_TPU

    code = BLOCK_CBAS_TPU + (
        "import contextlib, io, runpy\n"
        f"for name in {TOOLS!r}:\n"
        "    sys.argv = [name, '--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module('cbas_tpu_torch.tools.' + name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "    assert buf.getvalue().startswith('usage:'), (name, buf.getvalue()[:200])\n"
        "    print(name)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == list(TOOLS)
