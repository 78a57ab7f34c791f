"""Directory-backed project data model.

Copy of ``cbas_tpu/core/project.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

A CBAS project is a directory tree (reference: ProjectDirectory.md,
backend/cbas.py:679-711,833-901,1009-1136):

    project/
      cbas_config.yaml            (optional; encoder id)
      cameras/<name>/config.yaml
      recordings/<session>/<subject>/*.mp4 (+ *_cls.h5, *_<model>_outputs.csv)
      data_sets/<name>/config.yaml + labels.yaml (+ performance_report.yaml, ...)
      models/<name>/model.pth|model.npz + config.yaml + model_meta.json

Everything here is host-side, device-free and rebuilt by re-scanning the tree.
"""

from __future__ import annotations

import os
import shutil
from collections import Counter
from typing import Dict, List, Optional

from cbas_tpu_torch.core.config import (
    CameraSettings,
    ProjectSettings,
    dump_yaml,
    load_yaml,
)
from cbas_tpu_torch.core.splits import RandomSplitProvider, subject_of
from cbas_tpu_torch.utils.naming import (
    H5_SUFFIX,
    OUTPUTS_SUFFIX,
    h5_path_for_video,
    is_staging_artifact,
    sort_videos_by_segment,
)


class InvalidProject(Exception):
    def __init__(self, path: str):
        super().__init__(f"Path '{path}' is not a valid CBAS project directory.")


class Recording:
    """One subject folder inside a recording session: videos + derived files."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        self.path = path
        self.name = os.path.basename(path)
        files = [e.path for e in os.scandir(path) if e.is_file()]

        # *.tmp.mp4 are crash-orphanable staging files (atomic standardize/
        # augment writes), never real recordings.
        self.video_files = sort_videos_by_segment(
            [f for f in files if f.endswith(".mp4") and not is_staging_artifact(f)]
        )
        self.encoding_files = [f for f in files if f.endswith(H5_SUFFIX)]
        enc_set = set(self.encoding_files)
        self.unencoded_files = [
            v for v in self.video_files if h5_path_for_video(v) not in enc_set
        ]

        # Group per-model output CSVs: <videostem>_<model>_outputs.csv.
        # Longest video stem first: "cam_00001_aug_m_outputs.csv" must bind to
        # video "cam_00001_aug" (model "m"), not to "cam_00001" as a phantom
        # model "aug_m" — scandir order would otherwise decide.
        self.classifications: Dict[str, List[str]] = {}
        video_stems = sorted(
            (os.path.splitext(os.path.basename(v))[0] for v in self.video_files),
            key=len,
            reverse=True,
        )
        for csv_path in [f for f in files if f.endswith(OUTPUTS_SUFFIX)]:
            stem = os.path.basename(csv_path)[: -len(OUTPUTS_SUFFIX)]
            for vstem in video_stems:
                if stem.startswith(vstem + "_"):
                    model_name = stem[len(vstem) + 1 :]
                    self.classifications.setdefault(model_name, []).append(csv_path)
                    break


class Model:
    """A trained model bundle directory (config + weights [+ metadata])."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)
        self.config_path = os.path.join(path, "config.yaml")
        if not os.path.exists(self.config_path):
            raise FileNotFoundError(f"Model config not found: {self.config_path}")
        self.config = load_yaml(self.config_path)
        # Weights may be the reference's torch state_dict or our native npz.
        self.weights_path: Optional[str] = None
        for candidate in ("model.npz", "model.pth"):
            p = os.path.join(path, candidate)
            if os.path.exists(p):
                self.weights_path = p
                break
        if self.weights_path is None:
            raise FileNotFoundError(f"Model weights not found in: {path}")
        self.meta_path = os.path.join(path, "model_meta.json")


class Dataset:
    """A labeled dataset: behavior list + per-behavior labeled instances."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)
        self.config_path = os.path.join(path, "config.yaml")
        self.labels_path = os.path.join(path, "labels.yaml")
        if not os.path.exists(self.config_path):
            raise FileNotFoundError(f"Dataset config not found: {self.config_path}")
        self.config = load_yaml(self.config_path)
        if self.config is None:
            # yaml.safe_load of an empty/null file returns None — a truncated
            # config would otherwise crash every .get() downstream
            raise ValueError(f"Dataset config is empty: {self.config_path}")
        if not os.path.exists(self.labels_path):
            behaviors = self.config.get("behaviors", [])
            self.labels = {"behaviors": behaviors, "labels": {b: [] for b in behaviors}}
            dump_yaml(self.labels, self.labels_path)
        else:
            self.labels = load_yaml(self.labels_path)
            if self.labels is None:
                # empty/truncated labels.yaml: heal like the missing-file
                # branch instead of surfacing NoneType errors mid-session
                behaviors = self.config.get("behaviors", [])
                self.labels = {"behaviors": behaviors, "labels": {b: [] for b in behaviors}}
                dump_yaml(self.labels, self.labels_path)
        # Normalize at the source: a hand-edited `behavior:` key (YAML null)
        # must read as an empty list, or every consumer that iterates
        # labels["labels"].values() (labeling session, augmentation, label
        # sets, training manifests) crashes on NoneType — clean_and_sort /
        # all_instances guard it individually, but list-typed values here
        # make the whole surface safe.
        lbl = self.labels.get("labels")
        if isinstance(lbl, dict):
            for b, insts in list(lbl.items()):
                if not isinstance(insts, list):
                    lbl[b] = []
        else:
            self.labels["labels"] = {}

    @property
    def behaviors(self) -> List[str]:
        return list(self.config.get("behaviors", []))

    def all_instances(self) -> List[dict]:
        # isinstance guard like analyze_label_conflicts/clean_and_sort_labels:
        # a hand-edited labels.yaml with `behavior:` (YAML null) must not
        # crash every consumer.
        return [
            inst
            for b_insts in self.labels.get("labels", {}).values()
            if isinstance(b_insts, list)
            for inst in b_insts
        ]

    def save_labels(self) -> None:
        dump_yaml(self.labels, self.labels_path)

    def update_metric(self, behavior: str, group: str, value) -> None:
        self.set_metric(behavior, group, value)
        dump_yaml(self.config, self.config_path)

    def set_metric(self, behavior: str, group: str, value) -> None:
        """In-memory metric update; callers batch these and dump once."""
        self.config.setdefault("metrics", {}).setdefault(behavior, {})[group] = value

    def update_instance_counts_in_config(self) -> None:
        """Refresh the canonical per-behavior instance/frame counts.

        Uses the same fixed seed-42, 80/0/20 unstratified split as the
        reference (backend/cbas.py:864-901) so dataset cards show identical
        numbers across implementations.
        """
        insts = self.all_instances()
        behaviors = self.behaviors
        if not insts:
            for b in behaviors:
                self.set_metric(b, "Train Inst (Frames)", "0 (0)")
                self.set_metric(b, "Test Inst (Frames)", "0 (0)")
            dump_yaml(self.config, self.config_path)  # one write for all rows
            return

        subjects = list({subject_of(i) for i in insts})
        provider = RandomSplitProvider(seed=42, split_ratios=(0.8, 0.0, 0.2), stratify=False)
        train_subjects, _, test_subjects = provider.get_split(0, subjects, insts, behaviors)
        train_set, test_set = set(train_subjects), set(test_subjects)

        def counts(selected: set) -> tuple[Counter, Counter]:
            # stripped labels + tolerant field access, mirroring
            # engine/data.py build_manifest: the dataset card must count the
            # same instances training will actually use, and a malformed
            # hand-edited instance must not crash the card refresh
            chosen = [i for i in insts if subject_of(i) in selected]
            n_inst: Counter = Counter()
            n_frames: Counter = Counter()
            for i in chosen:
                label = str(i.get("label", "")).strip()
                start, end = i.get("start"), i.get("end")
                if not label or start is None or end is None:
                    continue
                n_inst[label] += 1
                n_frames[label] += int(end) - int(start) + 1
            return n_inst, n_frames

        tr_i, tr_f = counts(train_set)
        te_i, te_f = counts(test_set)
        for b in behaviors:
            self.set_metric(b, "Train Inst (Frames)", f"{tr_i.get(b, 0)} ({int(tr_f.get(b, 0))})")
            self.set_metric(b, "Test Inst (Frames)", f"{te_i.get(b, 0)} ({int(te_f.get(b, 0))})")
        dump_yaml(self.config, self.config_path)  # one write for all rows


class Project:
    """Root object: scans the tree and exposes cameras/recordings/models/datasets."""

    SUBDIRS = ("cameras", "recordings", "models", "data_sets")

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise InvalidProject(path)
        self.path = path
        self.cameras_dir = os.path.join(path, "cameras")
        self.recordings_dir = os.path.join(path, "recordings")
        self.models_dir = os.path.join(path, "models")
        self.datasets_dir = os.path.join(path, "data_sets")
        for d in (self.cameras_dir, self.recordings_dir, self.models_dir, self.datasets_dir):
            os.makedirs(d, exist_ok=True)

        self.reload_settings()
        self.reload()

    def reload_settings(self) -> None:
        """(Re-)read cbas_config.yaml (e.g. after switching encoders)."""
        self.settings = ProjectSettings()
        cfg_path = os.path.join(self.path, "cbas_config.yaml")
        if os.path.exists(cfg_path):
            try:
                self.settings = ProjectSettings.from_dict(load_yaml(cfg_path))
            except Exception as e:  # malformed config falls back to defaults
                print(f"WARNING: could not parse cbas_config.yaml ({e}); using defaults.")

    @property
    def encoder_model_identifier(self) -> str:
        """The configured encoder. A relative path naming a checkpoint
        directory inside the project resolves against the project root, so
        projects that ship their own encoder (see examples/demo_project) stay
        portable across machines."""
        ident = self.settings.encoder_model_identifier
        if not os.path.isabs(ident):
            local = os.path.join(self.path, ident)
            if os.path.isdir(local):
                return local
        return ident

    # -- scanning ----------------------------------------------------------

    def reload(self) -> None:
        self._load_cameras()
        self._load_recordings()
        self._load_models()
        self._load_datasets()

    def reload_recordings(self) -> None:
        self._load_recordings()

    def _load_cameras(self) -> None:
        self.cameras: Dict[str, CameraSettings] = {}
        for d in (e for e in os.scandir(self.cameras_dir) if e.is_dir()):
            cfg = os.path.join(d.path, "config.yaml")
            if not os.path.exists(cfg):
                continue
            try:
                data = load_yaml(cfg)
                if data and "name" in data:
                    self.cameras[data["name"]] = CameraSettings.from_dict(data)
            except Exception as e:
                print(f"Error loading camera config {cfg}: {e}")

    def _load_recordings(self) -> None:
        self.recordings: Dict[str, Dict[str, Recording]] = {}
        for session in (e for e in os.scandir(self.recordings_dir) if e.is_dir()):
            self.recordings[session.name] = {}
            for subject in (e for e in os.scandir(session.path) if e.is_dir()):
                try:
                    rec = Recording(subject.path)
                    self.recordings[session.name][rec.name] = rec
                except Exception as e:
                    print(f"Error loading recording {subject.path}: {e}")

    def _load_models(self) -> None:
        self.models: Dict[str, Model] = {}
        for d in (e for e in os.scandir(self.models_dir) if e.is_dir()):
            try:
                self.models[d.name] = Model(d.path)
            except Exception as e:
                print(f"Error loading model {d.path}: {e}")

    def _load_datasets(self) -> None:
        self.datasets: Dict[str, Dataset] = {}
        for d in (e for e in os.scandir(self.datasets_dir) if e.is_dir()):
            try:
                self.datasets[d.name] = Dataset(d.path)
            except Exception as e:
                print(f"Error loading dataset {d.path}: {e}")

    # -- creation / deletion ------------------------------------------------

    @staticmethod
    def create_project(parent_directory: str, project_name: str) -> Optional["Project"]:
        project_path = os.path.join(parent_directory, project_name)
        if os.path.exists(project_path):
            return None
        for sub in Project.SUBDIRS:
            os.makedirs(os.path.join(project_path, sub))
        return Project(project_path)

    def create_camera(self, name: str, settings: dict) -> Optional[CameraSettings]:
        cam_dir = os.path.join(self.cameras_dir, name)
        if os.path.exists(cam_dir):
            return None
        data = dict(settings)
        data["name"] = name
        cam = CameraSettings.from_dict(data)
        self.save_camera(cam)
        return cam

    def save_camera(self, cam: CameraSettings) -> None:
        cam_dir = os.path.join(self.cameras_dir, cam.name)
        os.makedirs(cam_dir, exist_ok=True)
        dump_yaml(cam.to_dict(), os.path.join(cam_dir, "config.yaml"))
        self.cameras[cam.name] = cam

    def rename_camera(self, old_name: str, new_name: str) -> bool:
        """Move cameras/<old>/ to cameras/<new>/ and rewrite the config name
        (reference: record_page.py:326-360 rename_camera_internal). Refuses if
        the target name already exists; the caller must stop any active
        stream/preview first (the recorder indexes sessions by camera name)."""
        new_name = new_name.strip()
        if not new_name or old_name not in self.cameras:
            return False
        if new_name == old_name:
            return True
        new_dir = os.path.join(self.cameras_dir, new_name)
        if new_name in self.cameras or os.path.exists(new_dir):
            return False
        os.rename(os.path.join(self.cameras_dir, old_name), new_dir)
        cam = self.cameras.pop(old_name)
        cam.name = new_name
        self.save_camera(cam)
        return True

    def create_dataset(
        self, name: str, behaviors: List[str], recordings_whitelist: List[str]
    ) -> Optional[Dataset]:
        d = os.path.join(self.datasets_dir, name)
        if os.path.exists(d):
            return None
        os.makedirs(d, exist_ok=True)
        dump_yaml(
            {"name": name, "behaviors": behaviors, "whitelist": recordings_whitelist, "model": None},
            os.path.join(d, "config.yaml"),
        )
        dump_yaml(
            {"behaviors": behaviors, "labels": {b: [] for b in behaviors}},
            os.path.join(d, "labels.yaml"),
        )
        ds = Dataset(d)
        self.datasets[name] = ds
        return ds

    def delete_dataset(self, name: str) -> bool:
        ds = self.datasets.get(name)
        if ds is None:
            return False
        try:
            if os.path.isdir(ds.path):
                shutil.rmtree(ds.path)
            for mp in (os.path.join(self.models_dir, name), os.path.join(self.models_dir, f"{name}_model")):
                if os.path.isdir(mp):
                    shutil.rmtree(mp)
            self.datasets.pop(name, None)
            self.models.pop(name, None)
            self.models.pop(f"{name}_model", None)
            return True
        except Exception as e:
            print(f"Error deleting dataset '{name}': {e}")
            self.reload()
            return False

    # -- derived views -------------------------------------------------------

    def all_video_files(self) -> List[str]:
        out: List[str] = []
        for session in self.recordings.values():
            for rec in session.values():
                out.extend(rec.video_files)
        return out

    def stale_or_missing_embeddings(self) -> List[str]:
        """Videos whose H5 is absent, unstamped, or stamped by another encoder.

        These must be (re-)encoded before use (reference: backend/startup_page.py:82-126).
        """
        todo: List[str] = []
        for video in self.all_video_files():
            h5 = h5_path_for_video(video)
            if not os.path.exists(h5):
                todo.append(video)
                continue
            # h5py only where an H5 exists: a project without any loads on
            # a host without h5py.
            from cbas_tpu_torch.core import hdf5_store

            if not hdf5_store.is_stamp_valid(h5, self.encoder_model_identifier):
                todo.append(video)
        return todo
