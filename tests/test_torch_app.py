"""cbas_tpu_torch's app: the product loop over HTTP on the CPU, and the
device rules of its entry points.

The loop runs a copy of ``examples/demo_project`` (an encoder of 2 heads of
64 at depth 2, 8 clips of 300 frames at 64x64) through the port's
``RpcServer`` over ``Api(device="cpu")``, with the JSON RPCs the frontend
sends, as ``tests/test_e2e_http.py`` does for the JAX app. The project asks
for fp32 (``runtime.compute_dtype``) so one clip's H5 can be held against the
JAX package's encode of it within one fp16 ulp (see test_torch_encoder.py).
Every wait has a deadline (chip_smoke.py's helpers, which its app phase
uses on the card).
"""

import os
import shutil
import subprocess
import sys
import time
import urllib.request

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_encoder import DEMO_ENCODER, _same_rows, assert_within_fp16_ulp

from chip_smoke import app_drained, rpc, wait_for, write_spans_clip
from cbas_tpu_torch.app.api import Api
from cbas_tpu_torch.app.server import RpcServer
from cbas_tpu_torch.core.config import dump_yaml, load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "examples", "demo_project")
CLIP = os.path.join("recordings", "sess1", "mouse0", "mouse0_00001.mp4")


def _demo_copy(tmp_path, **settings):
    proj = str(tmp_path / "demo")
    shutil.copytree(DEMO, proj)
    path = os.path.join(proj, "cbas_config.yaml")
    dump_yaml({**load_yaml(path), **settings}, path)
    return proj


def test_product_loop_over_http_on_cpu(tmp_path):
    import jax.numpy as jnp

    from cbas_tpu.engine.encode import encode_file as jax_encode_file
    from cbas_tpu.models.encoder import FrameEncoder as JaxFrameEncoder
    from cbas_tpu.utils import metrics as jax_metrics
    from cbas_tpu_torch.core.config import EncodeConfig
    from cbas_tpu_torch.engine.encode import EncodeStats, _encode_file_reuse
    from cbas_tpu_torch.models.encoder import FrameEncoder

    torch.set_num_threads(2)
    proj = _demo_copy(tmp_path, runtime={"compute_dtype": "float32"})
    jax_before = jax_metrics.metrics.snapshot()
    api = Api(device="cpu")
    srv = RpcServer(api)
    port = srv.start()
    try:
        # 1. load: the encoder is ready, on the CPU
        assert rpc(port, "load_project", proj)["success"]
        status = rpc(port, "get_cbas_status")
        assert status["encoder_ready"] and status["encoder_device"] == "cpu"

        # 2. the stale sweep queued the 8 clips; the encode worker drains them
        wait_for("encode queue", lambda: app_drained(port, 8))
        metrics = rpc(port, "get_metrics")
        assert sum(metrics.get(m, {}).get("units", 0)
                   for m in ("encode_frames", "encode_frames_cold")) >= 8 * 300
        # the JAX package's counters never see the port's work
        assert jax_metrics.metrics.snapshot() == jax_before

        # 3. one clip's H5 against the JAX package's encode of the same clip
        clip = os.path.join(tmp_path, "jax", os.path.basename(CLIP))
        os.makedirs(os.path.dirname(clip))
        shutil.copy(os.path.join(DEMO, CLIP), clip)
        ref = JaxFrameEncoder(DEMO_ENCODER, compute_dtype=jnp.float32)
        want_path = jax_encode_file(ref, clip)
        got_path = os.path.join(proj, CLIP.replace(".mp4", "_cls.h5"))
        with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
            assert dict(g.attrs) == dict(w.attrs)
            assert g["cls"].shape == w["cls"].shape == (300, 128)
            assert g["cls"].chunks == w["cls"].chunks
            assert_within_fp16_ulp(g["cls"][:], w["cls"][:])

        # 4. train a small head on the committed labels (2 epochs)
        marker = os.path.join(proj, "models", "demo_behaviors_model", "model.npz")
        t0 = os.path.getmtime(marker)
        assert rpc(port, "train_model", "demo_behaviors", epochs=2, sequence_length=15,
                    lstm_hidden_size=16, batch_size=64, learning_rate=0.003, num_runs=1,
                    num_trials=1, use_test=False, patience=3)
        wait_for("training", lambda: os.path.getmtime(marker) > t0)

        # 5. classify every encoded clip
        assert rpc(port, "start_classification", "demo_behaviors_model",
                    [os.path.join(proj, "recordings")]) == 8

        def csvs():
            found = sorted(os.path.join(r, f) for r, _, fs in os.walk(proj) for f in fs
                           if f.endswith("_demo_behaviors_model_outputs.csv"))
            return found if len(found) == 8 else None

        written = wait_for("classification", csvs)
        for csv in written:
            probs = pd.read_csv(csv)
            assert probs.shape == (300, 2) and np.allclose(probs.to_numpy().sum(1), 1, atol=1e-5)

        # 6. review labeling with the model's predictions, both refilter modes
        assert rpc(port, "start_labeling_with_preload", "demo_behaviors",
                    "demo_behaviors_model", CLIP, 0)
        assert rpc(port, "refilter_instances", 50, "above")
        assert rpc(port, "refilter_instances", 50, "below")

        # 7. plots from the fresh predictions
        acto = rpc(port, "generate_actograms", os.path.join(proj, "recordings", "sess1"),
                    "mouse0", "demo_behaviors_model", ["active"], 0.0116, 60, 0, 0.5, "LD",
                    False, 1)
        assert acto and len(acto.get("active", "")) > 1000  # a base64 PNG
        assert len(rpc(port, "generate_ethogram", written[0], 10) or "") > 1000

        # 8. reload with the reuse-gated encode on; re-encode one clip through
        # the worker and hold it against a direct call. The demo clips move
        # in every frame, so the clip is replaced by one with static spans.
        dump_yaml({**load_yaml(os.path.join(proj, "cbas_config.yaml")),
                   "encode": {"reuse_threshold": 6.0}}, os.path.join(proj, "cbas_config.yaml"))
        os.remove(got_path)
        write_spans_clip(os.path.join(proj, CLIP), 300)
        assert rpc(port, "load_project", proj)["success"]
        assert api.state.project.settings.encode.reuse_threshold == 6.0
        wait_for("re-encode", lambda: os.path.exists(got_path) and app_drained(port, 1))
        with h5py.File(got_path, "r") as f:
            worker_rows = f["cls"][:]
        direct = os.path.join(tmp_path, "direct", os.path.basename(CLIP))
        os.makedirs(os.path.dirname(direct))
        shutil.copy(os.path.join(proj, CLIP), direct)
        stats = EncodeStats()
        enc = FrameEncoder(DEMO_ENCODER, compute_dtype=torch.float32, device="cpu")
        direct_h5 = _encode_file_reuse(enc, direct, None, EncodeConfig(reuse_threshold=6.0),
                                       None, stats)
        with h5py.File(direct_h5, "r") as f:
            direct_rows = f["cls"][:]
        same = _same_rows(worker_rows)
        worker_keys = 1 + int((~same[np.arange(1, 300), np.arange(299)]).sum())
        assert stats.reused_frames > 0 and worker_keys == stats.key_frames
        assert stats.key_frames + stats.reused_frames == 300
        np.testing.assert_array_equal(same, _same_rows(direct_rows))
        np.testing.assert_array_equal(worker_rows, direct_rows)
    finally:
        api.kill_all_processes()
        srv.stop()


def test_api_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        Api(device="cuda")


def _main(*args, **popen):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # PYTHONUNBUFFERED as the desktop shell sets it (shell/main.js), so the
    # server line arrives as it is printed
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, "-m", "cbas_tpu_torch.app.main", *args], env=env,
                            cwd=ROOT, text=True, **popen)


def test_main_without_a_card_exits_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = _main("--headless", "--project", _demo_copy(tmp_path), stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in out + err and "Eel server starting" not in out


def test_main_on_cpu_serves(tmp_path):
    proc = _main("--device", "cpu", "--project", _demo_copy(tmp_path), "--port", "0",
                 "--frontend", os.path.join(ROOT, "frontend"), stdout=subprocess.PIPE,
                 stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        port = None
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            assert line, "the app exited before it served"
            if line.startswith("Eel server starting on http://localhost:"):
                port = int(line.strip().rsplit(":", 1)[1])
        assert port, "no server line"
        status = rpc(port, "get_cbas_status")
        assert status["project_loaded"] and status["encoder_device"] == "cpu"
        with urllib.request.urlopen(f"http://localhost:{port}/", timeout=30) as resp:
            assert b"<html" in resp.read().lower()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_chip_smoke_app_phase_runs_on_cpu():
    """chip_smoke.py's app phase on the CPU with every host package."""
    import chip_smoke
    from cbas_tpu_torch.ops import flash_attention as fa

    torch.set_num_threads(2)
    line = chip_smoke.app_phase(torch, fa, "cpu", device="cpu")
    assert line["ok"] and line["encoder_device"] == "cpu"
    assert line["skipped"] == {} and line["reuse"]["reused"] > 0 and line["csvs"] == 8


def test_chip_smoke_app_phase_without_host_packages():
    """The app phase as on the card's host: h5py, matplotlib, scikit-learn,
    jax and cbas_tpu blocked in a fresh interpreter. It loads the project,
    encodes with the app's encoder and names each file step it skips."""
    from test_torch_imports import BLOCK_CBAS_TPU, _fresh_python

    code = BLOCK_CBAS_TPU + (
        "for m in ('h5py', 'matplotlib', 'sklearn', 'jax'): sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import chip_smoke\n"
        "from cbas_tpu_torch.ops import flash_attention as fa\n"
        "line = chip_smoke.app_phase(torch, fa, 'cpu', device='cpu')\n"
        "assert line['ok'] and line['encoder_device'] == 'cpu', line\n"
        "assert line['skipped']['train'] == 'not installed: h5py', line\n"
        "assert len(line['skipped']) == 6, line\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        "             if m.split('.')[0] in ('jax', 'h5py', 'matplotlib', 'sklearn', 'cbas_tpu')\n"
        "             and v is not None))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
