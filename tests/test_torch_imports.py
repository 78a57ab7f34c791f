"""cbas_tpu_torch never imports jax, its device path imports nothing of
cbas_tpu, and chip_smoke.py refuses to run without a CUDA device.

conftest imports jax into every test process, so the import checks run in a
fresh interpreter.
"""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import cbas_tpu_torch
from cbas_tpu.core.config import InferenceConfig as JaxInferenceConfig
from cbas_tpu.utils import naming as jax_naming
from cbas_tpu_torch.engine.infer import InferenceConfig
from cbas_tpu_torch.utils import naming

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["cbas_tpu_torch"]
    for info in pkgutil.walk_packages(cbas_tpu_torch.__path__, "cbas_tpu_torch."):
        names.append(info.name)
    return names


def _fresh_python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )


def test_no_module_imports_jax():
    names = _modules()
    assert {"cbas_tpu_torch.ops.flash_attention", "cbas_tpu_torch.models.encoder",
            "cbas_tpu_torch.engine.infer", "cbas_tpu_torch.engine.encode"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import cbas_tpu.core.hdf5_store, cbas_tpu.ingest.decode\n"
        "import chip_smoke\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_device_path_imports_nothing_of_cbas_tpu():
    """What chip_smoke.py drives (a preset's config, FrameEncoder, an
    in-memory bundle's head, predict_frames) loads no module of jax or of the
    JAX package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import chip_smoke\n"
        "from cbas_tpu_torch.engine.classifier import ClassifierBundle\n"
        "from cbas_tpu_torch.engine.infer import InferenceSession\n"
        "from cbas_tpu_torch.models.encoder import FrameEncoder\n"
        "from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params\n"
        "from cbas_tpu_torch.models.vit import ViTConfig, config_for_identifier\n"
        "assert config_for_identifier('dinov3-vitb16').hidden_size == 768\n"
        "cfg = ViTConfig(variant='dinov3', hidden_size=128, num_layers=2, num_heads=2,\n"
        "                intermediate_size=256, layer_norm_eps=1e-5)\n"
        "enc = FrameEncoder('dinov3-vitb16', cfg=cfg, random_init=True, device='cpu')\n"
        "emb = enc.encode_planes(np.zeros((3, 32, 32), np.uint8), batch=4)\n"
        "hc = DeltasHeadConfig(in_features=128, out_features=2, seq_len=5, lstm_hidden_size=8)\n"
        "b = ClassifierBundle(name='m', behaviors=['a', 'b'], seq_len=5,\n"
        "                     params=init_deltas_params(0, hc), lstm_hidden_size=8)\n"
        "assert InferenceSession(b, device='cpu').predict_frames(emb, 2, 2).shape == (3, 2)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cbas_tpu')))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_copied_helpers_equal_cbas_tpu(tmp_path):
    """The two helpers copied so the device path stays free of cbas_tpu."""
    demo = os.path.join(ROOT, "examples", "demo_project", "demo_encoder")
    ckpt = tmp_path / "weights.pth"
    ckpt.write_bytes(bytes(range(256)) * 1000)
    for ident in (demo, demo + "/", str(ckpt), "facebook/dinov3-vitb16", "dinov3-vitb16",
                  "/nowhere/enc", "sub/enc"):
        assert naming.canonical_encoder_identity(ident) == \
            jax_naming.canonical_encoder_identity(ident), ident
    assert "#" in naming.canonical_encoder_identity(demo)
    assert dataclasses.asdict(InferenceConfig()) == dataclasses.asdict(JaxInferenceConfig())


def test_sources_use_no_jax_and_no_library_attention():
    banned = re.compile(r"import jax|from jax|scaled_dot_product_attention|torch\.compile")
    pkg = os.path.join(ROOT, "cbas_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not banned.search(fh.read()), os.path.join(dirpath, f)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (here) it exits non-zero and prints no result line; a
    directory holding chip_smoke.py alone cannot run it either."""
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, cwd=cwd, env=env,
            timeout=300,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
