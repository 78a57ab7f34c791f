"""cbas_tpu_torch imports nothing of jax or of cbas_tpu: no source names
them (the scripted demo under ``examples/`` among them; its whole run with
both blocked is in test_torch_demo.py), and its device, training and file
paths run in an interpreter where importing cbas_tpu raises (the training
path with jax and h5py blocked too).
chip_smoke.py refuses to run without a CUDA device.

conftest imports jax into every test process, so the import checks run in a
fresh interpreter.
"""

import ast
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import pytest

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


# Prepended to the code run in a fresh interpreter: a finder that raises on
# any import of cbas_tpu or its submodules (cbas_tpu_torch is not one).
BLOCK_CBAS_TPU = (
    "import sys\n"
    "class _BlockCbasTpu:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name == 'cbas_tpu' or name.startswith('cbas_tpu.'):\n"
    "            raise ImportError(f'cbas_tpu is blocked: {name}')\n"
    "sys.meta_path.insert(0, _BlockCbasTpu())\n"
)


def _port_sources():
    """Every .py of the port, and the scripts that drive it on the card."""
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "chip_ab.py", "chip_slices.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "cbas_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


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
            "cbas_tpu_torch.engine.infer", "cbas_tpu_torch.engine.encode",
            "cbas_tpu_torch.examples.end_to_end_demo"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "import chip_smoke, chip_ab, chip_slices\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_imports_cbas_tpu():
    """No import statement of the port or of its card scripts, at module
    level or inside a function, names cbas_tpu or a submodule of it."""
    sources = _port_sources()
    assert len(sources) > 30
    assert os.path.join(ROOT, "cbas_tpu_torch", "examples", "end_to_end_demo.py") in sources
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] != "cbas_tpu", f"{path}:{node.lineno} imports {name}"


def test_device_path_imports_nothing_of_cbas_tpu():
    """What chip_smoke.py drives (a preset's config, FrameEncoder, an
    in-memory bundle's head, predict_frames) runs with cbas_tpu blocked and
    loads no module of jax."""
    code = BLOCK_CBAS_TPU + (
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


def test_training_path_runs_without_jax_and_h5py():
    """With jax and h5py blocked, as on the card's machine, and cbas_tpu
    blocked: train_head for one epoch on in-memory embeddings, a bundle built
    in memory from its params, and predict_frames."""
    code = BLOCK_CBAS_TPU + (
        "sys.modules['jax'] = sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "from cbas_tpu_torch.engine.classifier import ClassifierBundle\n"
        "from cbas_tpu_torch.engine.data import WindowSource\n"
        "from cbas_tpu_torch.engine.infer import InferenceSession\n"
        "from cbas_tpu_torch.engine.train import train_head\n"
        "class Cache:\n"
        "    def __init__(self, arrays): self.arrays = arrays\n"
        "    def get(self, path): return {'cls': self.arrays[path]}\n"
        "    def read_window(self, path, a, b): return self.arrays[path][a:b]\n"
        "rng = np.random.default_rng(0)\n"
        "arrays = {f'r{i}': np.concatenate([rng.normal(2, 1, (60, 16)), rng.normal(-2, 1, (60, 16))])\n"
        "          .astype(np.float16) for i in range(2)}\n"
        "manifest = lambda p: [(p, c, 0) for c in range(5, 50)] + [(p, c, 1) for c in range(70, 110)]\n"
        "cache = Cache(arrays)\n"
        "train = WindowSource(manifest('r0'), 7, cache=cache, preload=True)\n"
        "val = WindowSource(manifest('r1'), 7, cache=cache, preload=True)\n"
        "params, reports, best = train_head(train, val, 7, ['a', 'b'], batch_size=32, lr=5e-3,\n"
        "                                   epochs=1, lstm_hidden_size=8, device='cpu')\n"
        "assert best == 0 and len(reports) == 1 and reports[0].val_report\n"
        "b = ClassifierBundle(name='m', behaviors=['a', 'b'], seq_len=7, params=params,\n"
        "                     lstm_hidden_size=8)\n"
        "probs = InferenceSession(b, device='cpu').predict_frames(arrays['r1'], 3, 3)\n"
        "assert probs.shape == (120, 2) and np.allclose(probs.sum(1), 1, atol=1e-5)\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        "             if m.split('.')[0] in ('jax', 'h5py', 'cbas_tpu') and v is not None))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_files_path_runs_with_cbas_tpu_blocked():
    """encode_file on a tiny synthetic clip, then infer_h5 with an in-memory
    bundle, with cbas_tpu blocked (where the host has h5py and OpenCV)."""
    pytest.importorskip("h5py")
    pytest.importorskip("cv2")
    code = BLOCK_CBAS_TPU + (
        "import os, tempfile\n"
        "import numpy as np, pandas as pd\n"
        "import chip_smoke\n"
        "from cbas_tpu_torch.engine.classifier import ClassifierBundle\n"
        "from cbas_tpu_torch.engine.encode import EncodeConfig, EncodeStats, encode_file\n"
        "from cbas_tpu_torch.engine.infer import InferenceSession\n"
        "from cbas_tpu_torch.models.encoder import FrameEncoder\n"
        "from cbas_tpu_torch.models.heads import DeltasHeadConfig, init_deltas_params\n"
        "from cbas_tpu_torch.models.vit import ViTConfig\n"
        "cfg = ViTConfig(variant='dinov3', hidden_size=64, num_layers=2, num_heads=2,\n"
        "                intermediate_size=128, layer_norm_eps=1e-5)\n"
        "enc = FrameEncoder('dinov3-vitb16', cfg=cfg, random_init=True, device='cpu')\n"
        "video = os.path.join(tempfile.mkdtemp(), 'm0_00001.mp4')\n"
        "chip_smoke.write_clip(video, 20, 0, size=64)\n"
        "h5 = encode_file(enc, video, config=EncodeConfig(chunk_frames=8), stats=EncodeStats())\n"
        "hc = DeltasHeadConfig(in_features=64, out_features=2, seq_len=5, lstm_hidden_size=8)\n"
        "b = ClassifierBundle(name='m', behaviors=['a', 'b'], seq_len=5,\n"
        "                     params=init_deltas_params(0, hc), lstm_hidden_size=8)\n"
        "probs = pd.read_csv(InferenceSession(b, device='cpu').infer_h5(h5)).to_numpy()\n"
        "assert probs.shape == (20, 2) and np.allclose(probs.sum(1), 1, atol=1e-5)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cbas_tpu')))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_app_imports_and_loads_without_host_packages(tmp_path):
    """As on the card's machine: with h5py, matplotlib, scikit-learn, jax and
    cbas_tpu blocked, the app's entry points import, and Api(device="cpu")
    loads a copy of the demo project with its encoder ready."""
    code = BLOCK_CBAS_TPU + (
        "for m in ('h5py', 'matplotlib', 'sklearn', 'jax'): sys.modules[m] = None\n"
        "import shutil\n"
        "import cbas_tpu_torch.app.main, cbas_tpu_torch.app.workers\n"
        "from cbas_tpu_torch.app.api import Api\n"
        f"shutil.copytree({os.path.join(ROOT, 'examples', 'demo_project')!r}, {str(tmp_path / 'p')!r})\n"
        "api = Api(device='cpu')\n"
        "api.state.encode_tasks.append = lambda path: False  # no encodes: they need h5py\n"
        f"assert api.load_project({str(tmp_path / 'p')!r})['success']\n"
        "status = api.get_cbas_status()\n"
        "assert status['encoder_ready'] and status['encoder_device'] == 'cpu', status\n"
        "api.kill_all_processes()\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        "             if m.split('.')[0] in ('jax', 'h5py', 'matplotlib', 'sklearn', 'cbas_tpu')\n"
        "             and v is not None))\n"
    )
    proc = _fresh_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_copied_helpers_equal_cbas_tpu(tmp_path):
    """The helpers the device path reaches, held equal to their originals
    (tests/test_torch_copies.py holds every copied module)."""
    demo = os.path.join(ROOT, "examples", "demo_project", "demo_encoder")
    ckpt = tmp_path / "weights.pth"
    ckpt.write_bytes(bytes(range(256)) * 1000)
    for ident in (demo, demo + "/", str(ckpt), "facebook/dinov3-vitb16", "dinov3-vitb16",
                  "/nowhere/enc", "sub/enc"):
        for fn in ("canonical_encoder_identity", "encoder_identity_candidates"):
            assert getattr(naming, fn)(ident) == getattr(jax_naming, fn)(ident), (fn, ident)
        assert naming.identities_equivalent(ident, demo) == \
            jax_naming.identities_equivalent(ident, demo), ident
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
