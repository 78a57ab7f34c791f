"""The port's copies of the JAX package's framework-free modules, held equal
to their originals: the same outputs on the same inputs, and files written by
either read by both.

cbas_tpu_torch imports nothing of cbas_tpu, so it keeps its own copies of
``core/{config,hdf5_store,project,splits}.py``, ``utils/{logging,metrics,
naming}.py``, ``models/torch_port.py``, ``engine/plots.py``,
``engine/data.py::build_manifest`` and ``ingest/decode.py`` with its native
loader. Each case below checks one of them.
"""

import dataclasses
import os
import re

import numpy as np
import pytest

import chip_smoke
from cbas_tpu.core import config as j_config
from cbas_tpu.core import hdf5_store as j_store
from cbas_tpu.core import project as j_project
from cbas_tpu.core import splits as j_splits
from cbas_tpu.engine import data as j_data
from cbas_tpu.engine import plots as j_plots
from cbas_tpu.engine.metrics import PerformanceReport as JPerformanceReport
from cbas_tpu.ingest import decode as j_decode
from cbas_tpu.models import torch_port as j_torch_port
from cbas_tpu.utils import logging as j_logging
from cbas_tpu.utils import metrics as j_metrics
from cbas_tpu.utils import naming as j_naming
from cbas_tpu_torch.core import config as t_config
from cbas_tpu_torch.core import hdf5_store as t_store
from cbas_tpu_torch.core import project as t_project
from cbas_tpu_torch.core import splits as t_splits
from cbas_tpu_torch.engine import data as t_data
from cbas_tpu_torch.engine import plots as t_plots
from cbas_tpu_torch.engine.metrics import PerformanceReport as TPerformanceReport
from cbas_tpu_torch.ingest import decode as t_decode
from cbas_tpu_torch.models import torch_port as t_torch_port
from cbas_tpu_torch.utils import logging as t_logging
from cbas_tpu_torch.utils import metrics as t_metrics
from cbas_tpu_torch.utils import naming as t_naming

BEHAVIORS = ["walk", "rest", "groom"]


def _instances(n_subjects=6, seed=0):
    """Labelled bouts over ``n_subjects`` subjects, every behaviour in each."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_subjects):
        for b in BEHAVIORS:
            for _ in range(int(rng.integers(1, 4))):
                start = int(rng.integers(0, 150))
                out.append({"video": f"recordings/day1/m{s}/m{s}_00001.mp4", "label": b,
                            "start": start, "end": start + int(rng.integers(5, 40))})
    return out


def check_naming(tmp_path):
    ckpt = tmp_path / "enc"
    ckpt.mkdir()
    (ckpt / "config.json").write_text("{}")
    (ckpt / "model.safetensors").write_bytes(bytes(range(256)) * 600)
    for ident in (str(ckpt), str(ckpt) + "/", "facebook/dinov3-vitb16", "dinov3-vitb16",
                  "/nowhere/enc", "sub/enc"):
        for fn in ("canonical_encoder_identity", "encoder_identity_candidates"):
            assert getattr(t_naming, fn)(ident) == getattr(j_naming, fn)(ident), (fn, ident)
        assert t_naming.identities_equivalent(ident, str(ckpt)) == \
            j_naming.identities_equivalent(ident, str(ckpt))
    videos = ["a/cam_00012.mp4", "a/cam_00003.mp4", "a/cam_00003_aug.mp4", "a/x.tmp.mp4", "a/cam.mp4"]
    for v in videos:
        for fn in ("h5_path_for_video", "segment_index", "is_staging_artifact"):
            assert getattr(t_naming, fn)(v) == getattr(j_naming, fn)(v), (fn, v)
        assert t_naming.outputs_csv_for_video(v, "m") == j_naming.outputs_csv_for_video(v, "m")
        h5 = j_naming.h5_path_for_video(v)
        assert t_naming.video_path_for_h5(h5) == j_naming.video_path_for_h5(h5)
        assert t_naming.outputs_csv_for_h5(h5, "m") == j_naming.outputs_csv_for_h5(h5, "m")
        csv = j_naming.outputs_csv_for_video(v, "m")
        assert t_naming.video_for_outputs_csv(csv, "m") == j_naming.video_for_outputs_csv(csv, "m")
    assert t_naming.sort_videos_by_segment(videos) == j_naming.sort_videos_by_segment(videos)
    csvs = [j_naming.outputs_csv_for_video(v, "m") for v in videos[:2]]
    assert t_naming.natural_sort_outputs(csvs, "m") == j_naming.natural_sort_outputs(csvs, "m")
    model = tmp_path / "model"
    model.mkdir()
    csv = tmp_path / "v_m_outputs.csv"
    csv.write_text("a\n")
    for weights in (False, True):
        if weights:
            (model / "model.npz").write_bytes(b"x")
            os.utime(model / "model.npz", (1e9 + 10, 1e9 + 10))
            os.utime(csv, (1e9, 1e9))
        assert t_naming.outputs_csv_is_stale(str(csv), str(model)) == \
            j_naming.outputs_csv_is_stale(str(csv), str(model))


def check_splits(tmp_path):
    insts = _instances(20)
    subjects = sorted({t_splits.subject_of(i) for i in insts})
    assert subjects == sorted({j_splits.subject_of(i) for i in insts})
    labels = {b: [i for i in insts if i["label"] == b] for b in BEHAVIORS}
    fp = t_splits.dataset_fingerprint(labels)
    assert fp == j_splits.dataset_fingerprint(labels)
    for seed, stratify in ((0, True), (7, False)):
        ours = t_splits.RandomSplitProvider(seed=seed, stratify=stratify)
        theirs = j_splits.RandomSplitProvider(seed=seed, stratify=stratify)
        for run in range(3):
            assert ours.get_split(run, subjects, insts, BEHAVIORS) == \
                theirs.get_split(run, subjects, insts, BEHAVIORS)
    splits = [{"train": subjects[:14], "validation": subjects[14:17], "test": subjects[17:]}]
    for writer, reader in ((t_splits, j_splits), (j_splits, t_splits)):
        path = str(tmp_path / f"{writer.__name__}.json")
        writer.write_split_manifest(path, splits, fp)
        got = reader.ManifestSplitProvider(path, fp).get_split(0, subjects, insts, BEHAVIORS)
        assert list(map(list, got)) == [subjects[:14], subjects[14:17], subjects[17:]]


def check_config(tmp_path):
    for name in ("CameraSettings", "ProjectSettings", "TrainingConfig", "InferenceConfig",
                 "EncodeConfig", "RuntimeConfig"):
        assert dataclasses.asdict(getattr(t_config, name)()) == \
            dataclasses.asdict(getattr(j_config, name)()), name
    assert (t_config.EMBED_DIM, t_config.DEFAULT_ENCODER) == \
        (j_config.EMBED_DIM, j_config.DEFAULT_ENCODER)
    task = {"name": "beh", "behaviors": BEHAVIORS, "batch_size": 64, "epochs": 3,
            "learning_rate": 3e-3, "use_test": True}
    for writer, reader in ((t_config, j_config), (j_config, t_config)):
        path = str(tmp_path / f"{writer.__name__}.yaml")
        writer.dump_yaml(writer.TrainingConfig(**task).to_dict(), path)
        back = reader.TrainingConfig.from_dict(reader.load_yaml(path))
        assert dataclasses.asdict(back) == dataclasses.asdict(j_config.TrainingConfig(**task))


def _describe(project):
    """What a loaded project holds, as plain data."""
    return {
        "settings": dataclasses.asdict(project.settings) if hasattr(project, "settings") else None,
        "datasets": {n: (d.behaviors, d.all_instances()) for n, d in project.datasets.items()},
        "cameras": sorted(project.cameras),
        "videos": sorted(os.path.relpath(v, project.path) for v in project.all_video_files()),
    }


def check_project(tmp_path):
    for i, (writer, reader) in enumerate(((t_project, j_project), (j_project, t_project))):
        proj = writer.Project.create_project(str(tmp_path / str(i)), "p")
        proj.create_camera("cam1", {"rtsp_url": "rtsp://x/profile1", "framerate": 15})
        ds = proj.create_dataset("beh", BEHAVIORS, [])
        ds.labels["labels"] = {b: [x for x in _instances(2) if x["label"] == b] for b in BEHAVIORS}
        ds.save_labels()
        for s in range(2):
            v = os.path.join(proj.recordings_dir, "day1", f"m{s}", f"m{s}_00001.mp4")
            os.makedirs(os.path.dirname(v))
            open(v, "wb").close()
        proj.reload()
        loaded = reader.Project(proj.path)
        assert _describe(loaded) == _describe(writer.Project(proj.path))
        assert loaded.encoder_model_identifier == proj.encoder_model_identifier


def check_hdf5_store(tmp_path):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((50, 768)).astype(np.float16)
    for writer, reader in ((t_store, j_store), (j_store, t_store)):
        path = str(tmp_path / f"{writer.__name__}_cls.h5")
        with writer.EmbeddingWriter(path, "dinov3-vitb16", chunk_rows=16) as w:
            w.append(emb[:30])
            w.append(emb[30:])
        for store in (t_store, j_store):
            assert store.num_frames(path) == 50
            assert store.encoder_stamp(path) == "dinov3-vitb16"
            assert store.is_stamp_valid(path, "dinov3-vitb16")
            np.testing.assert_array_equal(store.read_all(path), emb)
            np.testing.assert_array_equal(store.read_slice(path, 5, 9), emb[5:9])
            assert [s for s, _ in store.iter_chunks(path, 16)] == [0, 16, 32, 48]
        import h5py

        with h5py.File(path, "r") as f:
            assert f[reader.DATASET_NAME].chunks == (16, 768)
            assert f.attrs["schema_version"] == reader.SCHEMA_VERSION


def check_build_manifest(tmp_path):
    insts = _instances(3)
    for s in range(3):
        video = tmp_path / "recordings" / "day1" / f"m{s}" / f"m{s}_00001.mp4"
        video.parent.mkdir(parents=True)
        with j_store.EmbeddingWriter(j_naming.h5_path_for_video(str(video)), "e") as w:
            w.append(np.zeros((120 + 40 * s, 768), np.float16))
    insts.append({"video": "recordings\\day1\\m0\\m0_00001.mp4", "label": "walk", "start": 3, "end": 9})
    insts.append({"video": "recordings/day1/m1/m1_00001.mp4", "label": "other", "start": 3, "end": 9})
    insts.append({"video": "recordings/day9/x/x.mp4", "label": "walk", "start": 3, "end": 9})
    ours = t_data.build_manifest(str(tmp_path), insts, 15, BEHAVIORS)
    theirs = j_data.build_manifest(str(tmp_path), insts, 15, BEHAVIORS)
    assert ours == theirs and len(ours) > 100


def check_decode(tmp_path):
    path = str(tmp_path / "clip.mp4")
    chip_smoke.write_clip(path, 12, seed=2, size=64)
    for backend in ("opencv", "auto"):
        with t_decode.open_video(path, backend) as ours, j_decode.open_video(path, backend) as theirs:
            assert (ours.frame_count, ours.width, ours.height) == \
                (theirs.frame_count, theirs.width, theirs.height) == (12, 64, 64)
            np.testing.assert_array_equal(ours.read_batch(0, 12), theirs.read_batch(0, 12))
            np.testing.assert_array_equal(ours.read_green_batch(4, 5),
                                          theirs.read_green_batch(4, 5))
    assert t_decode.probe(path) == j_decode.probe(path)
    with pytest.raises(ValueError):
        t_decode.open_video(path, "decord")


def check_metrics(tmp_path):
    snaps = []
    for mod in (t_metrics, j_metrics):
        reg = mod.MetricsRegistry()
        reg.add(mod.ENCODE_FRAMES, 128, 0.5)
        reg.add(mod.ENCODE_FRAMES, 64, 0.25)
        reg.add(mod.TRAIN_STEPS, 3, 1.5)
        snap = reg.snapshot()
        snaps.append({k: {f: v for f, v in m.items() if f != "last_update"} for k, m in snap.items()})
    assert snaps[0] == snaps[1]
    names = ("DECODE_FRAMES", "ENCODE_FRAMES", "ENCODE_FRAMES_COLD", "INFER_WINDOWS",
             "INFER_FRAMES", "TRAIN_STEPS", "H5_ROWS")
    assert [getattr(t_metrics, n) for n in names] == [getattr(j_metrics, n) for n in names]
    assert t_metrics.metrics is not j_metrics.metrics  # the port's counters are its own


def check_logging(tmp_path, capsys=None):
    stamp = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")
    for level in ("INFO", "WARN", "ERROR", "bogus"):
        ours = t_logging.log_message("hello", level, to_queue=False)
        theirs = j_logging.log_message("hello", level, to_queue=False)
        assert stamp.sub("", ours) == stamp.sub("", theirs)
    t_logging.drain_log_queue()
    t_logging.log_message("queued")
    assert [stamp.sub("", x) for x in t_logging.drain_log_queue()] == ["[INFO] queued"]
    assert t_logging.LOG_QUEUE_MAX == j_logging.LOG_QUEUE_MAX


def check_torch_port(tmp_path):
    rng = np.random.default_rng(3)
    params = {"lin.weight": rng.standard_normal((4, 3)).astype(np.float32),
              "bn.num_batches_tracked": np.array(5), "lin.bias": np.zeros(4, np.float32)}
    for writer, reader in ((t_torch_port, j_torch_port), (j_torch_port, t_torch_port)):
        path = str(tmp_path / f"{writer.__name__}.pth")
        writer.save_pth(params, path)
        back = reader.load_pth(path)
        assert sorted(back) == ["lin.bias", "lin.weight"]
        for k, v in back.items():
            np.testing.assert_array_equal(v, params[k])
    assert t_torch_port.torch_available() == j_torch_port.torch_available()


def check_plots(tmp_path):
    rng = np.random.default_rng(4)
    cm = rng.integers(0, 9, (3, 3))
    rep = {b: {"precision": 0.5, "recall": 0.25, "f1-score": 0.3, "support": 4.0} for b in BEHAVIORS}
    rep["weighted avg"] = rep["walk"]
    written = []
    for mod, report in ((t_plots, TPerformanceReport), (j_plots, JPerformanceReport)):
        out = tmp_path / mod.__name__
        out.mkdir()
        mod.save_confusion_matrix_plot(cm, str(out / "cm.png"), BEHAVIORS)
        reports = [report(rep, cm, rep, cm) for _ in range(2)]
        mod.plot_epoch_metric(reports, "f1-score", BEHAVIORS, str(out))
        mod.plot_run_metrics([rep, rep], BEHAVIORS, str(out))
        written.append(sorted((p.name, p.stat().st_size > 0) for p in out.iterdir()))
    assert written[0] == written[1] and len(written[0]) == 5


CASES = {
    "naming": check_naming, "splits": check_splits, "config": check_config,
    "project": check_project, "hdf5_store": check_hdf5_store,
    "build_manifest": check_build_manifest, "decode": check_decode, "metrics": check_metrics,
    "logging": check_logging, "torch_port": check_torch_port, "plots": check_plots,
}


@pytest.mark.parametrize("module", sorted(CASES))
def test_copy_equals_original(module, tmp_path):
    CASES[module](tmp_path)
