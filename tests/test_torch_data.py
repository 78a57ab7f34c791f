"""cbas_tpu_torch's training data and metrics against the JAX package's.

The samplers and helpers are numpy copies: same seeds must give the same
index streams, weights and subsets (exact equality). The window sources and
the device store read the same HDF5 files (and the same RAM preloads) as the
JAX package's and must stack the same rows exactly. The report is a numpy
copy of scikit-learn's and must give the same keys and values (1e-12).
"""

import os

import jax
import numpy as np
import pytest
import torch

from cbas_tpu.core import hdf5_store
from cbas_tpu.engine import data as jdata
from cbas_tpu.engine import metrics as jmetrics
from cbas_tpu_torch.engine import data as tdata
from cbas_tpu_torch.engine import metrics as tmetrics

DIM = 32


def make_labeled_project(tmp_path, n_subjects=4, frames=200, seq_len=7, seed=0):
    """Synthetic project: per-subject H5 embeddings + separable labeled spans.

    The fixture of ``tests/test_train.py`` (that module loads the reference
    backend when imported, so it is repeated here)."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path)
    instances = []
    centers = {"walk": 2.0, "rest": -2.0}
    for s in range(n_subjects):
        rel = f"recordings/sess/m{s}/m{s}_00001.mp4"
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        h5 = os.path.join(root, rel).replace(".mp4", "_cls.h5")
        feats = np.zeros((frames, DIM), np.float16)
        half = frames // 2
        feats[:half] = rng.normal(centers["walk"], 1.0, (half, DIM))
        feats[half:] = rng.normal(centers["rest"], 1.0, (frames - half, DIM))
        with hdf5_store.EmbeddingWriter(h5, encoder_identifier="e", embed_dim=DIM) as w:
            w.append(feats)
        instances.append({"video": rel, "start": 10, "end": 60, "label": "walk"})
        instances.append({"video": rel, "start": half + 10, "end": half + 40, "label": "rest"})
    return root, instances, ["walk", "rest"]


class MemoryCache:
    """In-memory embeddings in the handle cache's interface."""

    def __init__(self, arrays):
        self.arrays = arrays

    def get(self, path):
        return {"cls": self.arrays[path]}

    def read_window(self, path, start, stop):
        return self.arrays[path][start:stop]


@pytest.fixture
def project(tmp_path):
    root, instances, behaviors = make_labeled_project(tmp_path, n_subjects=3)
    manifest = jdata.build_manifest(root, instances, 7, behaviors)
    yield root, instances, behaviors, manifest
    hdf5_store.global_handle_cache.close_all()


# ---------------------------------------------------------------------------
# Copied helpers: exact equality with the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_balanced_sampler_streams_equal(seed):
    rng = np.random.default_rng(seed)
    # uneven classes, a class index past num_behaviors, and an absent class
    manifest = [("f", i, int(l)) for i, l in enumerate(rng.choice([0, 1, 3, 7], 301, p=[.7, .2, .05, .05]))]
    for n_behaviors in (4, 2):
        ours = tdata.BalancedSampler(manifest, n_behaviors, seed=seed)
        ref = jdata.BalancedSampler(manifest, n_behaviors, seed=seed)
        assert len(ours) == len(ref)
        for _ in range(3):
            np.testing.assert_array_equal(ours.epoch_indices(), ref.epoch_indices())
    empty = tdata.BalancedSampler([("f", 0, 9)], 2)
    assert len(empty) == len(jdata.BalancedSampler([("f", 0, 9)], 2)) == 0
    assert empty.epoch_indices().size == 0


@pytest.mark.parametrize("shuffle", [False, True])
def test_sequential_sampler_streams_equal(shuffle):
    ours, ref = tdata.SequentialSampler(37, shuffle, 3), jdata.SequentialSampler(37, shuffle, 3)
    assert len(ours) == len(ref)
    for _ in range(2):
        np.testing.assert_array_equal(ours.epoch_indices(), ref.epoch_indices())


def test_class_weights_subjects_and_constants_equal():
    insts = ([{"label": "a ", "video": "r/s1/v.mp4"}] * 8 + [{"label": " b", "video": "r\\s2\\v.mp4"}] * 2
             + [{"label": "zz", "video": "r/s3/v.mp4"}])
    for behaviors in (["a", "b"], ["a", "b", "c"]):
        ours = tdata.compute_class_weights(insts, behaviors)
        ref = jdata.compute_class_weights(insts, behaviors)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    for subjects in (["r/s1"], ["r/s2", "r/s3"], []):
        assert tdata.instances_for_subjects(insts, subjects) == jdata.instances_for_subjects(insts, subjects)
    assert tdata.DATASET_NAME == hdf5_store.DATASET_NAME
    assert tdata._preload_budget_bytes() > 0


def test_iter_batches_and_window_sources_equal(project):
    root, _, _, manifest = project
    ours = tdata.WindowSource(manifest, 7)
    ref = jdata.WindowSource(manifest, 7)
    assert ours.embed_dim == ref.embed_dim == DIM and len(ours) == len(ref)
    np.testing.assert_array_equal(ours.labels(), ref.labels())
    got = list(tdata.iter_batches(ours, tdata.SequentialSampler(len(manifest)), 64))
    want = list(jdata.iter_batches(ref, jdata.SequentialSampler(len(manifest)), 64))
    assert len(got) == len(want) and got[-1][2] < 64  # a padded final batch
    for (x, y, n), (xr, yr, nr) in zip(got, want):
        assert n == nr
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)
    # the RAM preload holds the same spans and gathers the same windows
    pre, pre_ref = tdata.WindowSource(manifest, 7, preload=True), jdata.WindowSource(manifest, 7, preload=True)
    assert pre._ram.keys() == pre_ref._ram.keys()
    for path, (rows, off) in pre._ram.items():
        assert off == pre_ref._ram[path][1]
        np.testing.assert_array_equal(rows, pre_ref._ram[path][0])
    idx = np.arange(len(manifest))[::-3]
    for a, b in zip(pre.gather(idx), ref.gather(idx)):
        np.testing.assert_array_equal(a, b)


def test_window_source_serves_memory_cache(project):
    """An in-memory cache stands in for the HDF5 handle cache: same windows,
    lazy and preloaded."""
    _, _, _, manifest = project
    arrays = {p: hdf5_store.global_handle_cache.get(p)["cls"][:] for p in {e[0] for e in manifest}}
    ref_x, ref_y = jdata.WindowSource(manifest, 7).gather(range(len(manifest)))
    for preload in (False, True):
        src = tdata.WindowSource(manifest, 7, cache=MemoryCache(arrays), preload=preload)
        x, y = src.gather(range(len(manifest)))
        np.testing.assert_array_equal(x, ref_x)
        np.testing.assert_array_equal(y, ref_y)


@pytest.mark.parametrize("use_ram", [False, True], ids=["files", "ram"])
def test_device_window_store_matches_jax(project, use_ram):
    _, _, _, manifest = project
    ram = jdata.WindowSource(manifest, 7, preload=True)._ram if use_ram else None
    ours = tdata.DeviceWindowStore(manifest, 7, "cpu", ram=ram)
    ref = jdata.DeviceWindowStore(manifest, 7, ram=ram)
    assert ours.features.device.type == "cpu" and ours.features.dtype == torch.float16
    np.testing.assert_array_equal(ours.features.numpy(), np.asarray(jax.device_get(ref.features)))
    np.testing.assert_array_equal(ours.centers, ref.centers)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert (ours.embed_dim, ours.nbytes, ours.half) == (ref.embed_dim, ref.nbytes, ref.half)
    idx = np.arange(len(manifest))[5:40]
    for a, b in zip(ours.batch_indices(idx, 64), ref.batch_indices(idx, 64)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    centers, labels = ours.batch_indices(idx, 64)
    assert (labels[35:] == -1).all() and (centers[35:] == 3).all()  # label -1, centre `half`


# ---------------------------------------------------------------------------
# Metrics: the numpy report against scikit-learn's
# ---------------------------------------------------------------------------

def _random_case():
    rng = np.random.default_rng(0)
    return rng.integers(0, 4, 200), rng.integers(0, 4, 200), list("abcd")


@pytest.mark.parametrize(
    "y_true, y_pred, behaviors",
    [
        _random_case(),
        ([0, 0, 1, 1], [0, 0, 0, 0], ["a", "b", "c"]),  # never-predicted and absent classes
        ([0, 0, 0], [0, 0, 0], ["a", "b"]),              # one class only
        ([2, 2, 0], [1, 1, 1], ["a", "b", "c"]),          # nothing right
        ([0, 1, 5], [0, 1, 1], ["a", "b"]),               # a label outside the list
    ],
    ids=["random", "zero-division", "one-class", "all-wrong", "foreign-label"],
)
def test_report_and_cm_equal_sklearn(y_true, y_pred, behaviors):
    rep, cm = tmetrics.report_and_cm(np.array(y_true), np.array(y_pred), behaviors)
    want_rep, want_cm = jmetrics.report_and_cm(y_true, y_pred, behaviors)
    assert list(rep) == list(want_rep)
    for key, value in want_rep.items():
        if isinstance(value, dict):
            assert list(rep[key]) == list(value)
            for k, v in value.items():
                assert rep[key][k] == pytest.approx(v, rel=1e-12, abs=1e-15), (key, k)
        else:
            assert rep[key] == pytest.approx(value, rel=1e-12)
    assert cm.dtype == want_cm.dtype
    np.testing.assert_array_equal(cm, want_cm)
    for target in ("weighted avg", "macro avg", behaviors[0], "nothing"):
        assert tmetrics.f1_of(rep, target) == pytest.approx(jmetrics.f1_of(want_rep, target))
