"""The port's scripted demo (cbas_tpu_torch/examples/end_to_end_demo.py) on
the CPU, at its full size (8 clips of 300 frames at 64x64), and its files
read by the JAX package.

The demo runs once, in a fresh interpreter where importing jax or cbas_tpu
raises; the JAX package then reads what it wrote: its FrameEncoder over the
demo's encoder directory and its ClassifierBundle and infer_file over the
demo's bundle and H5.
"""

import glob
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest

pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

from test_torch_imports import BLOCK_CBAS_TPU, _fresh_python

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "demo_behaviors_model"
# JAX's encoder against the port's H5 rows: one fp16 ulp + ENCODE_ABS (PERF.md
# §2); measured on the CPU: every row within one ulp + 3.0e-7
ENCODE_ABS = 1e-4
# JAX's head against the port's CSV, absolute; measured on the CPU: 4.2e-20
INFER_ABS = 1e-4


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo's result dict, run with jax and cbas_tpu blocked."""
    root = str(tmp_path_factory.mktemp("demo"))
    proc = _fresh_python(BLOCK_CBAS_TPU + (
        "sys.modules['jax'] = None\n"
        "import json, torch\n"
        "torch.set_num_threads(2)\n"
        "from cbas_tpu_torch.examples import end_to_end_demo\n"
        f"got = end_to_end_demo.main({root!r}, device='cpu')\n"
        "got['loaded'] = sorted(m for m, v in sys.modules.items()\n"
        "                       if m.split('.')[0] in ('jax', 'cbas_tpu') and v is not None)\n"
        "print(json.dumps(got))\n"
    ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    return got


def _clip(got, i):
    return os.path.join(got["project"], "recordings", "sess1", f"mouse{i}", f"mouse{i}_00001")


def test_demo_writes_every_file(demo):
    from cbas_tpu_torch.examples import end_to_end_demo

    for i in range(end_to_end_demo.CLIPS):
        with h5py.File(_clip(demo, i) + "_cls.h5", "r") as f:
            cls = f["cls"]
            assert cls.shape == (end_to_end_demo.FRAMES, 128) and cls.dtype == np.float16
    assert demo["model_dir"] == os.path.join(demo["project"], "models", MODEL)
    for name in ("model.pth", "model.npz", "config.yaml", "model_meta.json"):
        assert os.path.isfile(os.path.join(demo["model_dir"], name)), name
    csvs = glob.glob(os.path.join(demo["project"], "recordings", "**", f"*_{MODEL}_outputs.csv"),
                     recursive=True)
    assert csvs == [demo["csv"]] == [_clip(demo, 0) + f"_{MODEL}_outputs.csv"]
    with open(demo["png"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert demo["p_active"] > 0.5 and demo["p_rest"] > 0.5


def test_jax_encoder_reads_the_demo_encoder(demo):
    """JAX's FrameEncoder over the demo's encoder directory, fp32, on clip
    0's planes: the port's H5 rows within one fp16 ulp + 1e-4."""
    import jax.numpy as jnp

    from cbas_tpu.models.encoder import FrameEncoder as JaxFrameEncoder
    from cbas_tpu_torch.examples import end_to_end_demo
    from cbas_tpu_torch.ingest.decode import open_video

    with open_video(_clip(demo, 0) + ".mp4") as reader:
        planes = reader.read_green_batch(0, end_to_end_demo.FRAMES)
    with h5py.File(_clip(demo, 0) + "_cls.h5", "r") as f:
        ours = f["cls"][:]
    ref = JaxFrameEncoder(os.path.join(demo["project"], "demo_encoder"),
                          compute_dtype=jnp.float32).encode_planes(planes)
    assert ref.shape == ours.shape and ref.dtype == np.float16
    diff = np.abs(ours.astype(np.float32) - ref.astype(np.float32))
    step = np.spacing(np.abs(ref)).astype(np.float32)
    assert (diff <= step + ENCODE_ABS).all(), float((diff - step).max())


def test_jax_head_reads_the_demo_bundle(demo, tmp_path):
    """JAX's ClassifierBundle.load and infer_file on the port's bundle and
    clip 0's H5: the port's CSV within INFER_ABS."""
    from cbas_tpu.core.project import Project as JaxProject
    from cbas_tpu.engine.classifier import ClassifierBundle as JaxBundle
    from cbas_tpu.engine.infer import infer_file as jax_infer_file

    identifier = JaxProject(demo["project"]).encoder_model_identifier
    bundle = JaxBundle.load(demo["model_dir"], expected_encoder=identifier)
    assert bundle.behaviors == ["active", "rest"]
    out = jax_infer_file(_clip(demo, 0) + "_cls.h5", bundle, output_csv=str(tmp_path / "j.csv"))
    ref, ours = pd.read_csv(out), pd.read_csv(demo["csv"])
    assert list(ref.columns) == list(ours.columns) and ref.shape == ours.shape
    assert float(np.abs(ref.to_numpy() - ours.to_numpy()).max()) <= INFER_ABS


def test_demo_without_a_card_exits_naming_cuda(tmp_path):
    root = tmp_path / "demo"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "cbas_tpu_torch.examples.end_to_end_demo",
                           str(root)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not root.exists()


def test_demo_names_missing_packages_and_chip_smoke_skips_it():
    """Without h5py and matplotlib, as on the card's host: the demo raises
    naming both before it writes anything, and chip_smoke.py's demo phase
    prints a skip naming them."""
    proc = _fresh_python(BLOCK_CBAS_TPU + (
        "for m in ('h5py', 'matplotlib', 'jax'): sys.modules[m] = None\n"
        "import os, tempfile\n"
        "import chip_smoke\n"
        "from cbas_tpu_torch.examples import end_to_end_demo\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    root = os.path.join(d, 'demo')\n"
        "    try:\n"
        "        end_to_end_demo.main(root, device='cpu')\n"
        "    except RuntimeError as e:\n"
        "        assert 'h5py, matplotlib' in str(e) and not os.path.exists(root), e\n"
        "    else:\n"
        "        raise AssertionError('the demo ran without h5py')\n"
        "line = chip_smoke.demo_phase('cpu', device='cpu')\n"
        "assert line == {'phase': 'demo', 'skipped': 'not installed: h5py, matplotlib'}, line\n"
        "print('ok')\n"
    ))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
