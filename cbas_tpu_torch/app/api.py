"""The application RPC surface: every function the frontend calls.

Name-for-name rebuild of the reference's ``@eel.expose`` API
(backend/app.py:40-383). Methods live on :class:`Api` so the surface is
testable headless; ``bind_eel()`` registers each public method with Eel when
the websocket frontend is in use. JS-push callbacks go through
``state.callbacks`` (see app/workers.py for the event names).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import pandas as pd
import torch

from cbas_tpu_torch.app import visualize
from cbas_tpu_torch.app.labeling import LabelingSession
from cbas_tpu_torch.app.media import (
    LivePreview,
    grab_frame,
    grab_frames_parallel,
)
from cbas_tpu_torch.app.preflight import (
    check_dataset_files_ready,
    get_disagreement_playlist,
    run_preflight_check,
)
from cbas_tpu_torch.app.state import AppState
from cbas_tpu_torch.app.workers import (
    TrainWorker,
    queue_encode_task,
    start_classification,
    start_workers,
    sweep_stale_embeddings,
)
from cbas_tpu_torch.core import labels as label_tools
from cbas_tpu_torch.core.config import CameraSettings, TrainingConfig, load_yaml
from cbas_tpu_torch.core.project import Project
from cbas_tpu_torch.engine.classifier import ClassifierBundle
from cbas_tpu_torch.engine.infer import InferenceSession
from cbas_tpu_torch.ingest.record import RecordingManager, run_monitor
from cbas_tpu_torch.ingest.standardize import (
    augment_dataset,
    import_videos,
    is_aug_video,
    resync_aug_labels,
)
from cbas_tpu_torch.ingest.watcher import RecordingWatcher
from cbas_tpu_torch.utils.logging import log_message
from cbas_tpu_torch.utils.naming import (
    OUTPUTS_SUFFIX,
    h5_path_for_video,
    outputs_csv_for_h5,
    outputs_csv_is_stale,
)


class Api:
    """All frontend-callable operations, bound to one AppState."""

    def __init__(self, state: Optional[AppState] = None, device="cuda"):
        """``device`` ("cuda" or "cpu") is where the encoder, inference and
        training run; an explicit ``state`` brings its own. A CUDA device
        that is not visible raises here: the app never falls back to the
        CPU."""
        self.state = state or AppState(device)
        if self.state.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Api(device='cuda') needs a CUDA device and none is visible; "
                "pass device='cpu' to run on the CPU"
            )
        self.recorder: Optional[RecordingManager] = None
        self._monitor_stop: Optional[threading.Event] = None
        self.watcher: Optional[RecordingWatcher] = None
        self.train_worker: Optional[TrainWorker] = None
        self._workers = None
        self._preview: Optional[LivePreview] = None

    # ------------------------------------------------------------------
    # Startup page
    # ------------------------------------------------------------------

    def get_project_root(self) -> Optional[str]:
        return self.state.project.path if self.state.project else None

    @staticmethod
    def _safe_component(name) -> Optional[str]:
        """Validate a wire-supplied name that becomes ONE path component
        (camera/dataset/session/subject). Every Api method is reachable from
        HTTP POST, so an absolute or ..-carrying 'name' would write outside
        the project tree (os.path.join discards preceding components for
        absolute paths) — the same class read_text_file is hardened against.
        """
        s = str(name or "").strip()
        if not s or s in (".", "..") or "/" in s or "\\" in s or os.sep in s:
            return None
        return s

    def create_project(self, parent_directory: str, project_name: str) -> dict:
        proj = Project.create_project(parent_directory, project_name)
        if proj is None:
            return {"success": False, "message": "Project already exists."}
        return self.load_project(proj.path)

    def load_project(self, path: str) -> dict:
        """Open a project, load its encoder, sweep stale embeddings, start the
        watcher (reference: backend/startup_page.py:56-136)."""
        st = self.state
        try:
            st.project = Project(path)
        except Exception as e:
            # reference startup error dialog (startup_page.py showErrorOnStartup)
            st.callbacks.emit("showErrorOnStartup", str(e))
            return {"success": False, "message": str(e)}

        try:
            from cbas_tpu_torch.parallel.mesh import runtime_mesh

            # A mesh is of CUDA devices: --device cpu runs on the CPU alone.
            st.mesh = runtime_mesh(st.project.settings.runtime) if st.device.type == "cuda" else None
            if st.mesh is not None:
                log_message(
                    f"Data-parallel mesh over {st.mesh.devices.size} devices "
                    f"({dict(st.mesh.shape)})."
                )
        except Exception as e:
            log_message(f"Mesh construction failed ({e}); using one device.", "WARN")
            st.mesh = None

        from cbas_tpu_torch.models.encoder import EncoderWeightsUnavailable, FrameEncoder

        try:
            # runtime.compute_dtype ("bfloat16" by default, "float32" for
            # parity runs) picks the encoder's matmul dtype.
            st.encoder = FrameEncoder(
                st.project.encoder_model_identifier, device=st.device, mesh=st.mesh,
                compute_dtype=getattr(torch, st.project.settings.runtime.compute_dtype),
            )
            log_message(
                f"Encoder ready: {st.project.encoder_model_identifier} on {st.device}"
            )
        except Exception as e:
            # A device fault (torch raises CUDA errors as RuntimeError) must
            # surface, not leave the app serving with encoding disabled.
            if isinstance(e, RuntimeError) and not isinstance(e, EncoderWeightsUnavailable):
                raise
            log_message(
                f"Encoder weights unavailable ({e}); encoding is disabled until "
                "a checkpoint is provided.",
                "WARN",
            )
            st.encoder = None

        if self.recorder is not None:
            # Switching projects must not orphan project A's ffmpeg
            # recorders: the new manager's dict can never reach them, so
            # they'd record into the old tree until process exit.
            self.recorder.stop_all()
        self.stop_live_preview()
        self.recorder = RecordingManager(
            st.project.recordings_dir,
            on_final_segment=self._queue_external_video,
        )
        # Self-heal monitor (reference: workthreads.py:139-176): restarts a
        # recording whose ffmpeg died. One daemon thread per project load;
        # the previous load's monitor is stopped so threads don't accumulate.
        if self._monitor_stop is not None:
            self._monitor_stop.set()
        self._monitor_stop = threading.Event()
        monitor = threading.Thread(
            target=run_monitor,
            args=(self.recorder, lambda: dict(st.project.cameras), self._monitor_stop),
            daemon=True,
            name="RecordingMonitor",
        )
        monitor.start()
        if st.encoder is not None:
            sweep_stale_embeddings(st)
        self.start_recording_watcher()
        st.shutdown.clear()  # a prior kill_all_processes must not gate new workers
        if self._workers is None:
            self._workers = start_workers(st)
            self.train_worker = self._workers[2]
        else:
            # A previous shutdown's bounded join left stragglers running.
            # shutdown is cleared, so live members resume; respawn only the
            # roles whose threads exited (never a duplicate over one queue).
            from cbas_tpu_torch.app.workers import ClassifyWorker, EncodeWorker, TrainWorker

            time.sleep(0.5)  # let members mid-exit finish dying
            roles = (EncodeWorker, ClassifyWorker, TrainWorker)
            ws = list(self._workers)
            for i, cls in enumerate(roles):
                if not ws[i].is_alive():
                    ws[i] = cls(st)
                    ws[i].start()
            self._workers = tuple(ws)
            self.train_worker = self._workers[2]
        return {"success": True, "path": st.project.path}

    def _queue_external_video(self, path: str) -> None:
        """Queue a video that something other than the watcher produced (an
        import, a stopped recording's final segment) — and tell the watcher,
        or its settle-promotion would encode the same file a second time."""
        if self.watcher is not None:
            self.watcher.mark_handled(path)
        queue_encode_task(self.state, path)

    def reload_project_data(self) -> bool:
        if self.state.project:
            self.state.project.reload()
            return True
        return False

    def start_recording_watcher(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        if self.state.project is None:
            return
        self.watcher = RecordingWatcher(
            self.state.project.recordings_dir,
            on_ready=lambda p: queue_encode_task(self.state, p),
        )
        self.watcher.start()

    def get_cbas_status(self) -> dict:
        st = self.state
        done, total = st.encode_progress()
        return {
            "project_loaded": st.project is not None,
            "encoder_ready": st.encoder is not None,
            # where the encoder's weights live (None without an encoder)
            "encoder_device": st.encoder.weights_device if st.encoder is not None else None,
            "encode_done": done,
            "encode_total": total,
            "live_model": st.live_inference_model_name,
        }

    def get_encoding_queue_status(self) -> dict:
        done, total = self.state.encode_progress()
        return {"queued": len(self.state.encode_tasks), "done": done, "total": total}

    def get_live_inference_status(self) -> dict:
        return {
            "model": self.state.live_inference_model_name,
            "queued": len(self.state.classify_tasks),
        }

    def get_metrics(self) -> dict:
        """Per-stage throughput counters (decode/encode fps, infer wps, ...)."""
        from cbas_tpu_torch.utils.metrics import metrics

        return metrics.snapshot()

    def kill_all_processes(self) -> None:
        self.state.shutdown.set()
        # A multi-epoch training job only polls training_cancel (not
        # shutdown); without this it outlives the 10 s join below.
        self.state.training_cancel.set()
        self.stop_live_preview()
        if self._monitor_stop is not None:
            self._monitor_stop.set()
        if self.recorder:
            self.recorder.stop_all()
        if self.watcher:
            self.watcher.stop()
        # Give workers a chance to finish the op in flight before the
        # process tears their threads down.
        if self._workers:
            for w in self._workers:
                w.join(timeout=10.0)
            if any(w.is_alive() for w in self._workers):
                # Keep the references: load_project must know stragglers
                # exist, or it would start a second trio over the same
                # queues while these still run.
                log_message(
                    "Worker(s) still draining after shutdown join: "
                    + ", ".join(w.name for w in self._workers if w.is_alive()),
                    "WARN",
                )
            else:
                self._workers = None

    # ------------------------------------------------------------------
    # Record page (cameras)
    # ------------------------------------------------------------------

    def get_camera_list(self) -> List[dict]:
        if not self.state.project:
            return []
        return [c.to_dict() for c in self.state.project.cameras.values()]

    def get_camera_settings(self, name: str) -> Optional[dict]:
        cam = self.state.project.cameras.get(name) if self.state.project else None
        return cam.to_dict() if cam else None

    def create_camera(self, name: str, settings: dict) -> bool:
        name = self._safe_component(name)
        if name is None:
            return False
        return bool(self.state.project and self.state.project.create_camera(name, settings))

    def save_camera_settings(self, name: str, settings: dict) -> bool:
        name = self._safe_component(name)
        if name is None or not self.state.project:
            return False
        data = dict(settings)
        data["name"] = name
        self.state.project.save_camera(CameraSettings.from_dict(data))
        return True

    def save_all_camera_settings(self, settings: dict) -> bool:
        """Apply shared settings fields to every camera."""
        if not self.state.project:
            return False
        for cam in list(self.state.project.cameras.values()):
            data = cam.to_dict()
            data.update({k: v for k, v in settings.items() if k != "name"})
            self.state.project.save_camera(CameraSettings.from_dict(data))
        return True

    def rename_camera(self, old_name: str, new_name: str) -> bool:
        """Rename a camera, moving its config directory (reference:
        record_page.py:307-360 — save_camera_settings delegates renames to
        rename_camera_internal, which stops the stream/preview first)."""
        new_name = self._safe_component(new_name)
        if new_name is None or not self.state.project:
            return False
        if self.recorder:
            self.recorder.stop(old_name)
        self.stop_live_preview()
        return self.state.project.rename_camera(old_name, new_name)

    def delete_camera(self, name: str) -> bool:
        proj = self.state.project
        if not proj or name not in proj.cameras:
            return False
        if self.recorder:
            self.recorder.stop(name)
        import shutil

        cam_dir = os.path.join(proj.cameras_dir, name)
        if os.path.isdir(cam_dir):
            shutil.rmtree(cam_dir)
        proj.cameras.pop(name, None)
        return True

    def get_single_camera_thumbnail(self, name: str) -> Optional[str]:
        cam = self.state.project.cameras.get(name) if self.state.project else None
        if cam is None or not cam.rtsp_url:
            return None
        b64 = grab_frame(cam.rtsp_url, resize=(cam.resolution, cam.resolution))
        # The reference UI receives thumbnails as a PUSH (record_page.py:67
        # eel.updateImageSrc), not from the RPC return; emit both ways.
        self.state.callbacks.emit("updateImageSrc", name, b64)
        return b64

    def fetch_specific_thumbnails(self, names: List[str]) -> Dict[str, Optional[str]]:
        """Grab many camera thumbnails concurrently (worker pool, see
        media.grab_frames_parallel) — serial RTSP grabs scale O(N) on
        many-camera rigs (reference: record_page.py:23-152)."""
        cams = self.state.project.cameras if self.state.project else {}
        sources = {
            n: (cams[n].rtsp_url, (cams[n].resolution, cams[n].resolution))
            for n in names
            if n in cams and cams[n].rtsp_url
        }
        out: Dict[str, Optional[str]] = {n: None for n in names}
        out.update(grab_frames_parallel(sources))
        for n, b64 in out.items():
            self.state.callbacks.emit("updateImageSrc", n, b64)
        return out

    def start_camera_stream(self, name: str, session_name: str) -> bool:
        # A blank session would flatten recordings to recordings/<camera>/,
        # invisible to the session/subject scan (same guard as import_videos).
        session_name = self._safe_component(session_name)
        if session_name is None:
            return False
        cam = self.state.project.cameras.get(name) if self.state.project else None
        if cam is None or self.recorder is None:
            return False
        return self.recorder.start(cam, session_name)

    def stop_camera_stream(self, name: str) -> bool:
        return bool(self.recorder and self.recorder.stop(name))

    def stop_all_camera_streams(self) -> bool:
        if self.recorder:
            self.recorder.stop_all()
        return True

    def get_active_streams(self) -> Dict[str, float]:
        """Active recording cameras -> epoch start time, so the UI can show
        per-camera elapsed timers (reference: record_page.py:437-447)."""
        if not self.recorder:
            return {}
        return self.recorder.snapshot_active()

    def start_live_preview(self, name: str) -> bool:
        cam = self.state.project.cameras.get(name) if self.state.project else None
        if cam is None or not cam.rtsp_url:
            return False
        self.stop_live_preview()
        self._preview = LivePreview(
            cam.rtsp_url,
            on_frame=lambda b64: self.state.callbacks.emit("update_live_frame", name, b64),
            on_end=lambda: self.state.callbacks.emit("end_live_preview", name),
        )
        self._preview.start()
        return True

    def stop_live_preview(self) -> bool:
        if self._preview is not None:
            self._preview.stop()
            self._preview = None
        return True

    def get_existing_session_names(self) -> List[str]:
        if not self.state.project:
            return []
        return sorted(self.state.project.recordings.keys())

    def reveal_recording_folder(
        self, session_name: Optional[str] = None, camera_name: Optional[str] = None
    ) -> Optional[str]:
        """No args: the recordings root. With the reference frontend's
        (session, camera) pair (record_page.js:119 / record_page.py:288),
        that subject's folder — None if it doesn't exist."""
        if not self.state.project:
            return None
        root = self.state.project.recordings_dir
        if session_name and camera_name:
            p = os.path.join(root, session_name, camera_name)
            return p if os.path.isdir(p) else None
        return root

    # ------------------------------------------------------------------
    # Record/inference trees
    # ------------------------------------------------------------------

    def get_record_tree(self) -> Dict[str, List[str]]:
        """session -> subject names."""
        if not self.state.project:
            return {}
        return {
            session: sorted(subjects.keys())
            for session, subjects in self.state.project.recordings.items()
        }

    def get_recording_tree(self) -> Dict[str, Dict[str, List[str]]]:
        """session -> subject -> video files (aug videos hidden)."""
        if not self.state.project:
            return {}
        return {
            session: {
                name: [v for v in rec.video_files if not is_aug_video(v)]
                for name, rec in subjects.items()
            }
            for session, subjects in self.state.project.recordings.items()
        }

    def get_hierarchical_video_list(
        self, dataset_name: Optional[str] = None
    ) -> Dict[str, Dict[str, List[dict]]]:
        """Session -> subject -> video entries, scoped to ``dataset_name``'s
        recording whitelist when one is set (reference:
        label_train_page.py:362-400 filters the labeling video list by the
        dataset's whitelisted session/subject dirs). An empty or absent
        whitelist means unrestricted — unlike the reference's empty-result,
        because this UI creates datasets without a mandatory whitelist step."""
        out: Dict[str, Dict[str, List[dict]]] = {}
        if not self.state.project:
            return out
        whitelist: List[str] = []
        if dataset_name:
            ds = self.state.project.datasets.get(dataset_name)
            if ds is not None:
                whitelist = [w.strip("/") for w in ds.config.get("whitelist", []) or []]

        def allowed(session: str, subject: str) -> bool:
            if not whitelist:
                return True
            key = f"{session}/{subject}"
            return any(w == session or w == key or key.startswith(w + "/")
                       for w in whitelist)

        labeled = self._labeled_video_set()
        root = self.state.project.path
        for session, subjects in self.state.project.recordings.items():
            out[session] = {}
            for name, rec in subjects.items():
                if not allowed(session, name):
                    continue
                out[session][name] = [
                    {
                        "path": v,
                        "encoded": os.path.exists(h5_path_for_video(v)),
                        "has_labels": os.path.relpath(v, root).replace("\\", "/") in labeled,
                    }
                    for v in rec.video_files
                    if not is_aug_video(v)
                ]
        return {s: subs for s, subs in out.items() if subs}

    def get_inferred_session_dirs(self, model_name: str) -> List[str]:
        """Sessions containing at least one output CSV for the model."""
        out = []
        if not self.state.project:
            return out
        for session, subjects in self.state.project.recordings.items():
            if any(model_name in rec.classifications for rec in subjects.values()):
                out.append(session)
        return sorted(out)

    def get_inferred_videos_for_session(self, model_name: str, session: str) -> Dict[str, List[str]]:
        """Subject -> video paths that have an outputs CSV for the model.

        Returns VIDEO paths (not CSVs), with augmented siblings and orphaned
        CSVs (video deleted) excluded — the reference's playback picker has
        the same contract (label_train_page.py:449-466)."""
        if not self.state.project:
            return {}
        from cbas_tpu_torch.utils.naming import video_for_outputs_csv

        subjects = self.state.project.recordings.get(session, {})
        out: Dict[str, List[str]] = {}
        for name, rec in subjects.items():
            videos = sorted(
                v
                for v in (
                    video_for_outputs_csv(c, model_name)
                    for c in rec.classifications.get(model_name, [])
                )
                if not is_aug_video(v) and os.path.exists(v)
            )
            if videos:
                out[name] = videos
        return out

    def get_classified_video_tree(self, model_name: Optional[str] = None):
        """With a model: {session: {subject: [video...]}} for that model (our
        UI). Without — the reference frontend's zero-arg shape
        (visualize_page.js:364 / visualize_page.py:361) — the reference's
        nested-list tree of videos classified by ANY model:
        [(session, [(subject, [{"name", "path"}...])...])...]."""
        if not self.state.project:
            return {} if model_name is not None else []
        if model_name is not None:
            return {
                session: self.get_inferred_videos_for_session(model_name, session)
                for session in self.get_inferred_session_dirs(model_name)
            }
        from cbas_tpu_torch.utils.naming import video_for_outputs_csv

        tree = []
        for session in sorted(self.state.project.recordings):
            subjects = []
            for name, rec in sorted(self.state.project.recordings[session].items()):
                classified = sorted(
                    {
                        v
                        for m, csvs in rec.classifications.items()
                        for v in (video_for_outputs_csv(c, m) for c in csvs)
                        if os.path.exists(v) and not is_aug_video(v)
                    }
                )
                if classified:
                    subjects.append(
                        (name, [{"name": os.path.basename(v), "path": v} for v in classified])
                    )
            if subjects:
                tree.append((session, subjects))
        return tree

    # ------------------------------------------------------------------
    # Import
    # ------------------------------------------------------------------

    def import_videos(
        self,
        sources: List[str],
        session_name: str,
        subject_name: str,
        standardize: bool = True,
        stretch: bool = False,
        crop: Optional[list] = None,
    ) -> List[str]:
        # Reject blank names like the reference (label_train_page.py:486) and
        # any separator/..-carrying component (wire-reachable path write):
        # joining bad components would drop imports into the recordings root
        # or outside the project tree entirely.
        session_name = self._safe_component(session_name)
        subject_name = self._safe_component(subject_name)
        if not self.state.project or session_name is None or subject_name is None:
            return []
        dest = os.path.join(self.state.project.recordings_dir, session_name, subject_name)
        imported = import_videos(
            sources,
            dest,
            standardize=standardize,
            stretch=stretch,
            crop=tuple(crop) if crop else None,
            progress_callback=lambda p, m: self.state.callbacks.emit(
                "update_import_progress", p, m
            ),
            # per-file, not post-batch: an early-finished file must be marked
            # handled before the watcher's settle delay elapses, or it gets
            # promoted (and encoded) a second time while later files import
            on_imported=self._queue_external_video,
        )
        self.state.project.reload_recordings()
        # reference completion toast (label_train_page.py:208-213)
        self.state.callbacks.emit(
            "notify_import_complete",
            bool(imported),
            f"Imported {len(imported)} video(s) to '{session_name}/{subject_name}'."
            if imported
            else "Import failed: no files were imported.",
        )
        return imported

    # ------------------------------------------------------------------
    # Datasets & labels
    # ------------------------------------------------------------------

    def create_dataset(self, name: str, behaviors: List[str], whitelist: List[str]) -> bool:
        name = self._safe_component(name)
        if name is None:
            return False
        return bool(
            self.state.project and self.state.project.create_dataset(name, behaviors, whitelist)
        )

    def delete_dataset(self, name: str) -> bool:
        return bool(self.state.project and self.state.project.delete_dataset(name))

    def load_dataset_configs(self) -> Dict[str, dict]:
        if not self.state.project:
            return {}
        return {name: ds.config for name, ds in self.state.project.datasets.items()}

    def update_dataset_whitelist(self, dataset_name: str, whitelist: List[str]) -> bool:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return False
        ds.config["whitelist"] = whitelist
        from cbas_tpu_torch.core.config import dump_yaml

        dump_yaml(ds.config, ds.config_path)
        return True

    def reveal_dataset_files(self, dataset_name: str) -> Optional[str]:
        """Path of the dataset folder (the UI opens it in the file manager)."""
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        return ds.path if ds else None

    def recalculate_dataset_stats(self, dataset_name: str) -> bool:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return False
        ds.update_instance_counts_in_config()
        return True

    def _labeled_video_set(self) -> set:
        """Relative paths of every labeled video, one pass over all datasets."""
        out = set()
        if not self.state.project:
            return out
        for ds in self.state.project.datasets.values():
            for insts in ds.labels.get("labels", {}).values():
                for i in insts:
                    out.add(str(i.get("video", "")).replace("\\", "/"))
        return out

    def video_has_labels(self, video_path: str, _ref_video: Optional[str] = None) -> bool:
        """One arg: does ANY dataset label this video (our UI's confirm).
        Two args — the reference frontend's (dataset_name, video_path) shape
        (label_train_page.js:1677 / label_train_page.py:572) — scope the
        check to that dataset's labels."""
        if not self.state.project:
            return False
        if _ref_video is not None:
            ds = self.state.project.datasets.get(video_path)
            if ds is None:
                return False
            rel = os.path.relpath(_ref_video, self.state.project.path).replace("\\", "/")
            return any(
                inst.get("video") == rel
                for insts in (ds.labels.get("labels") or {}).values()
                for inst in insts or []
            )
        rel = os.path.relpath(video_path, self.state.project.path).replace("\\", "/")
        return rel in self._labeled_video_set()

    def get_label_coverage_report(self, dataset_name: str) -> dict:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return {}
        return label_tools.coverage_report(ds.labels, ds.behaviors)

    def analyze_label_conflicts(self, dataset_name: str) -> dict:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return {"error": "Dataset not found."}
        return label_tools.analyze_label_conflicts(load_yaml(ds.labels_path))

    def clean_and_sort_labels(self, dataset_name: str) -> bool:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return False
        cleaned = label_tools.clean_and_sort_labels(load_yaml(ds.labels_path))
        from cbas_tpu_torch.core.config import dump_yaml

        dump_yaml(cleaned, ds.labels_path)
        ds.labels = cleaned
        return True

    def get_instances_for_behavior(self, dataset_name: str, behavior: str) -> Dict[str, list]:
        ds = self.state.project.datasets.get(dataset_name) if self.state.project else None
        if ds is None:
            return {}
        out: Dict[str, list] = {}
        for inst in ds.labels.get("labels", {}).get(behavior, []):
            out.setdefault(str(inst.get("video")), []).append(inst)
        return out

    def run_preflight_check(self, dataset_name: str, test_split: float) -> dict:
        if not self.state.project:
            return {"is_valid": False, "message": "No project loaded."}
        return run_preflight_check(self.state.project, dataset_name, test_split)

    def check_dataset_files_ready(self, dataset_name: str):
        if not self.state.project:
            return False, "No project loaded."
        return check_dataset_files_ready(self.state.project, dataset_name)

    def get_disagreement_playlist(self, dataset_name: str) -> List[dict]:
        if not self.state.project:
            return []
        return get_disagreement_playlist(self.state.project, dataset_name)

    def create_augmented_dataset(self, source_name: str, new_name: str) -> bool:
        # Same wire-name containment as create_dataset: new_name becomes a
        # path component (and delete_dataset would later rmtree it).
        new_name = self._safe_component(new_name)
        if not self.state.project or new_name is None:
            return False

        def worker():
            try:
                augment_dataset(
                    self.state.project, source_name, new_name,
                    progress_callback=lambda p, m: self.state.callbacks.emit(
                        "update_augmentation_progress", p, m
                    ),
                )
                self.state.callbacks.emit("refreshAllDatasets")
            except Exception as e:
                log_message(f"Augmentation failed: {e}", "ERROR")
                self.state.callbacks.emit("showErrorOnLabelTrainPage", str(e))
            finally:
                self.state.callbacks.emit("update_augmentation_progress", -1, "")

        threading.Thread(target=worker, daemon=True).start()
        return True

    def sync_augmented_dataset(self, dataset_name: str, target_name: Optional[str] = None) -> int:
        """One arg: the augmented dataset to resync from its source. Two args
        — the reference's (source, target) shape (label_train_page.js:752) —
        resync the TARGET (the augmented one; the source is derived from the
        aug labels themselves, so the first arg is informational)."""
        if not self.state.project:
            return 0
        return resync_aug_labels(self.state.project, target_name or dataset_name)

    # ------------------------------------------------------------------
    # Models / training / inference
    # ------------------------------------------------------------------

    def model_exists(self, model_name: str) -> bool:
        return bool(self.state.project and model_name in self.state.project.models)

    def get_available_models(self) -> List[str]:
        return sorted(self.state.project.models.keys()) if self.state.project else []

    def get_model_configs(self) -> Dict[str, dict]:
        if not self.state.project:
            return {}
        return {n: m.config for n, m in self.state.project.models.items()}

    def set_live_inference_model(self, model_name: Optional[str]) -> bool:
        from cbas_tpu_torch.app.workers import select_live_model

        # Routes through the supersede logic: flipping the live toggle while
        # another model's batch drains must not classify its queued files
        # with the new model.
        select_live_model(self.state, model_name)
        return True

    # Positional order matches the reference's 17-arg train_model
    # (backend/label_train_page.py:1804-1808) so the reference training
    # dialog's call works unchanged; our dialog passes keywords. The
    # reference JS sends numbers as strings — coerced below like the
    # reference's int()/float() casts.
    _TRAIN_POSITIONAL = (
        ("batch_size", int), ("learning_rate", float), ("epochs", int),
        ("sequence_length", int), ("training_method", str), ("patience", int),
        ("num_runs", int), ("num_trials", int), ("optimization_target", str),
        ("use_test", bool), ("test_split", float), ("custom_weights", None),
        ("weight_decay", float), ("label_smoothing", float),
        ("lstm_hidden_size", int), ("lstm_layers", int),
    )

    def train_model(self, dataset_name: str, *ref_args, **hyperparams) -> bool:
        """Queue a training job (the reference's 17-arg train_model)."""
        if len(ref_args) > len(self._TRAIN_POSITIONAL):
            raise TypeError(f"train_model takes at most {1 + len(self._TRAIN_POSITIONAL)} args")
        for (key, cast), val in zip(self._TRAIN_POSITIONAL, ref_args):
            if key in hyperparams:
                raise TypeError(f"train_model got duplicate argument {key!r}")
            hyperparams[key] = cast(val) if cast is not None and val is not None else val
        if not self.state.project or self.train_worker is None:
            return False
        ds = self.state.project.datasets.get(dataset_name)
        if ds is None:
            return False
        ready, msg = self.check_dataset_files_ready(dataset_name)
        if not ready:
            self.state.callbacks.emit("showErrorOnLabelTrainPage", msg)
            return False
        task = TrainingConfig(
            name=dataset_name, behaviors=ds.behaviors, **hyperparams
        )
        self.train_worker.queue_task(task)
        return True

    def cancel_training_task(self, dataset_name: str) -> None:
        """Cancel the running job AND drop queued ones (reference:
        workthreads.py:1069-1082 clears the whole queue on cancel)."""
        self.state.training_cancel.set()
        if self.train_worker is not None:
            dropped = self.train_worker.clear_queue()
            if dropped:
                log_message(f"Dropped {dropped} queued training job(s).", "WARN")
        self.state.callbacks.emit(
            "updateTrainingStatusOnUI", dataset_name, "Training cancelled by user."
        )

    def start_classification(self, model_name: str, whitelisted_dirs: List[str]) -> int:
        """Queue every H5 under the whitelisted dirs lacking this model's
        outputs (reference: backend/label_train_page.py:1853-1895)."""
        h5s: List[str] = []
        for d in whitelisted_dirs:
            for dirpath, _, files in os.walk(d):
                h5s.extend(
                    os.path.join(dirpath, f)
                    for f in files
                    # skip augmentation siblings' embeddings: their
                    # predictions are consumed by nothing (stitch_outputs
                    # and the labeling lists hide _aug artifacts) — pure
                    # wasted device time + CSV clutter
                    if f.endswith("_cls.h5") and not f.endswith("_aug_cls.h5")
                )
        return start_classification(self.state, model_name, h5s)

    # ------------------------------------------------------------------
    # Labeling session (delegates to LabelingSession)
    # ------------------------------------------------------------------

    @property
    def session(self) -> Optional[LabelingSession]:
        return self.state.labeling_session

    def _abs_video(self, video_path: str) -> str:
        """Accept both absolute paths (reference UI convention) and
        project-relative paths (the labels.yaml convention)."""
        if not os.path.isabs(video_path) and self.state.project is not None:
            return os.path.join(self.state.project.path, video_path)
        return video_path

    def start_labeling(self, dataset_name: str, video_path: str,
                       preloaded_instances: Optional[List[dict]] = None,
                       filter_for_behavior: Optional[str] = None) -> bool:
        # Positional shape matches the reference's start_labeling(name,
        # video, instances, filter_for_behavior) (backend/app.py:228) so the
        # reference frontend's 4-arg call works unchanged.
        return self._start_session(
            dataset_name, self._abs_video(video_path), preloaded_instances,
            filter_for_behavior,
        )

    def get_videos_for_dataset(self, dataset_name: str) -> List[List[str]]:
        """[path, display] pairs of the dataset's whitelist-scoped videos —
        the reference frontend's pre-label modal calls this
        (label_train_page.js:1658) but the reference backend never defines
        it, leaving that picker stuck on 'Loading videos…'; here it works."""
        out: List[List[str]] = []
        for sess, subjects in self.get_hierarchical_video_list(dataset_name).items():
            for subj, vids in subjects.items():
                for v in vids:
                    out.append(
                        [v["path"], f"{sess}/{subj}/{os.path.basename(v['path'])}"]
                    )
        return out

    def start_labeling_with_preload(
        self, dataset_name: str, model_name: str, video_path: str, smoothing_window: int
    ) -> bool:
        """Guided labeling: infer on the video, convert to confidence
        instances, open a review session (reference: label_train_page.py:980-1096)."""
        proj = self.state.project
        if proj is None:
            return False
        video_path = self._abs_video(video_path)
        model = proj.models.get(model_name)
        if model is None:
            return False
        ds = proj.datasets.get(dataset_name)
        h5 = h5_path_for_video(video_path)
        if not os.path.exists(h5):
            # still queued / encode failed: a friendly error beats the raw
            # OSError 500 h5py would raise (matches start_playback_session)
            self.state.callbacks.emit(
                "showErrorOnLabelTrainPage",
                "Video has no embeddings yet (encoding pending or failed); "
                "guided labeling needs the encoded file.",
            )
            return False
        try:
            bundle = ClassifierBundle.load(
                model.path, expected_encoder=proj.encoder_model_identifier
            )
        except Exception as e:
            self.state.callbacks.emit("showErrorOnLabelTrainPage", str(e))
            return False
        if ds is not None:
            missing = [b for b in ds.behaviors if b not in bundle.behaviors]
            if missing:
                self.state.callbacks.emit(
                    "showErrorOnLabelTrainPage",
                    f"Model lacks dataset behaviors: {', '.join(missing)}",
                )
                return False
        csv = outputs_csv_for_h5(h5, model_name)
        # Re-infer when the CSV predates the model's saved weights: after a
        # same-name retrain, a stale CSV would present the PREVIOUS model's
        # predictions as guidance (same staleness rule as the disagreement
        # report, engine/orchestrator.py generate_disagreement_report).
        if outputs_csv_is_stale(csv, model.path):
            try:
                csv = InferenceSession(bundle, mesh=self.state.mesh, device=self.state.device).infer_h5(
                    h5, output_csv=csv)
            except Exception as e:
                self.state.callbacks.emit(
                    "showErrorOnLabelTrainPage", f"Inference failed: {e}"
                )
                return False
            if csv is None:
                return False
        df = pd.read_csv(csv)
        rel = os.path.relpath(video_path, proj.path).replace("\\", "/")
        instances, _ = label_tools.predictions_to_instances_with_confidence(
            df, bundle.behaviors, rel, smoothing_window=smoothing_window
        )
        # The session renders the DATASET's vocabulary; a model behavior the
        # dataset lacks would enter the buffer as an invisible yet active
        # instance — un-renderable, blocking new labels via the overlap
        # guard, and committable into labels.yaml as an orphan label.
        if ds is not None:
            allowed = set(ds.behaviors)
            instances = [i for i in instances if i.get("label") in allowed]
        return self._start_session(dataset_name, video_path, instances, None, model_name)

    def _start_session(self, dataset_name, video_path, preloaded, filter_for,
                       model_name="", **session_kw) -> bool:
        if self.state.labeling_session is not None:
            self.state.labeling_session.close()
            # Clear BEFORE constructing the replacement: if the constructor
            # raises, a half-dead (capture-released) session must not stay
            # installed — keystrokes would edit a video the user can't see.
            self.state.labeling_session = None
        try:
            session = LabelingSession(
                self.state.project,
                dataset_name,
                video_path,
                preloaded_instances=preloaded,
                filter_for_behavior=filter_for,
                callbacks=self.state.callbacks,
                model_name=model_name,
                **session_kw,
            )
        except Exception as e:
            log_message(f"Failed to start labeling session: {e}", "ERROR")
            self.state.callbacks.emit("showErrorOnLabelTrainPage", str(e))
            return False
        self.state.labeling_session = session
        self.state.callbacks.emit(
            "buildLabelingUI", session.behaviors, session.colors, filter_for
        )
        self.state.callbacks.emit("setLabelingModeUI", session.mode, model_name)
        session.render_payload()
        return True

    def start_playback_session(self, dataset_name, model_name, video_path=None, _ref_predictions=None) -> bool:
        """Read-only playback of the MODEL'S predictions through the labeling
        renderer (reference: label_train_page.py:1902-1929): the model's
        outputs CSV becomes the timeline, every instance shown regardless of
        confidence, all edits blocked.

        Also accepts the reference frontend's 4-arg shape
        (video_path, behaviors, colors, predictions) from
        label_train_page.js:1345 — detected by the list in the second slot;
        the model is resolved from the video's newest outputs CSV (the
        shipped colors/predictions round-trip is unnecessary server-side)."""
        proj = self.state.project
        if proj is None:
            return False
        if isinstance(model_name, (list, tuple)):
            video_path = self._abs_video(dataset_name)
            found = self._latest_outputs_csv(video_path)
            if found is None:
                return False
            model_name = found[1]
            # playback ignores the dataset's labels; any dataset anchors the
            # session (behaviors come from the model override below)
            if not proj.datasets:
                return False
            dataset_name = next(iter(sorted(proj.datasets)))
        else:
            video_path = self._abs_video(video_path)
        csv = outputs_csv_for_h5(h5_path_for_video(video_path), model_name)
        if not os.path.exists(csv):
            self.state.callbacks.emit(
                "showErrorOnLabelTrainPage",
                f"No predictions for '{model_name}' on this video — run inference first.",
            )
            return False
        model = proj.models.get(model_name)
        behaviors = None
        if model is not None:
            # behavior names only — reading them from the already-parsed
            # config.yaml avoids deserializing the full weights per playback
            # click (and read-only playback keeps working even if the weights
            # file is corrupt)
            behaviors = list(model.config.get("behaviors") or []) or None
        df = pd.read_csv(csv)
        rel = os.path.relpath(video_path, proj.path).replace("\\", "/")
        behaviors = behaviors or list(df.columns)
        instances, _ = label_tools.predictions_to_instances_with_confidence(
            df, behaviors, rel, smoothing_window=1
        )
        # playback=True: the session takes the predictions verbatim (no
        # confidence filter, no human-interval subtraction — a saturated
        # softmax block has confidence exactly 1.0 and must still render),
        # uses the MODEL's behavior vocabulary, and rejects all edits.
        return self._start_session(
            dataset_name, video_path, instances, None, model_name,
            playback=True, behaviors_override=behaviors,
        )

    def get_current_labeling_video_path(self) -> Optional[str]:
        return self.session.rel_video if self.session else None

    # per-keystroke session ops — thin delegation with re-render
    def _with_session(self, fn) -> bool:
        if self.session is None:
            return False
        fn(self.session)
        self.session.render_payload()
        return True

    def save_session_labels(self) -> dict:
        if self.session is None:
            return {"status": "error", "message": "Labeling session not active."}
        result = self.session.save()
        self.session.render_payload()
        return result

    def refilter_instances(self, threshold: int, mode: str = "below") -> bool:
        return self._with_session(lambda s: s.refilter(threshold, mode))

    def jump_to_frame(self, frame: int) -> bool:
        return self._with_session(lambda s: s.jump_to_frame(frame))

    def next_frame(self, shift: int) -> bool:
        return self._with_session(lambda s: s.next_frame(shift))

    def next_video(self, shift: int) -> bool:
        # Single-video sessions: re-render (kept for API parity).
        return self._with_session(lambda s: None)

    def jump_to_instance(self, direction: int) -> bool:
        return self._with_session(lambda s: s.jump_to_instance(direction))

    def handle_click_on_label_image(self, x: int, y: int) -> bool:
        return self._with_session(lambda s: s.click_timeline(x))

    def get_zoom_range_for_click(self, x: int) -> bool:
        def zoom(s: LabelingSession):
            if 0 <= s.selected_index < len(s.buffer):
                inst = s.buffer[s.selected_index]
                # Zoom frames the ORIGINAL extent when present: refiltered/
                # nudged instances keep _original_start/_original_end until
                # the next commit strips them, and the reference centers the
                # zoom bar on that pre-trim extent
                # (backend/label_train_page.py:1474-1475).
                start = inst.get("_original_start", inst["start"])
                end = inst.get("_original_end", inst["end"])
                context = (end - start) * 2
                z0 = max(0, start - context)
                z1 = min(s.total_frames, end + context)
                if z1 > z0:
                    from cbas_tpu_torch.app.labeling import TIMELINE_WIDTH

                    s.jump_to_frame(int(z0 + (x / TIMELINE_WIDTH) * (z1 - z0)))

        return self._with_session(zoom)

    def label_frame(self, value: int) -> bool:
        return self._with_session(lambda s: s.label_frame(value))

    def delete_instance_from_buffer(self) -> bool:
        return self._with_session(lambda s: s.delete_instance())

    def pop_instance_from_buffer(self) -> bool:
        return self._with_session(lambda s: s.undo_last())

    def confirm_selected_instance(self) -> bool:
        return self._with_session(lambda s: s.confirm_selected())

    def update_instance_boundary(self, boundary_type: str) -> bool:
        return self._with_session(lambda s: s.update_instance_boundary(boundary_type))

    def stage_for_commit(self) -> bool:
        def f(s):
            # Read-only playback must not stage: confirmation_mode hides
            # every unconfirmed prediction, which in playback is the ENTIRE
            # timeline (nothing is ever confirmable there).
            if s.mode != "playback":
                s.confirmation_mode = True
        return self._with_session(f)

    def cancel_commit_stage(self) -> bool:
        def f(s):
            s.confirmation_mode = False
        return self._with_session(f)

    def get_frame_from_video(self, video_path: str, frame_index: int = 0) -> Optional[str]:
        # frame_index defaults to 0 for the reference frontend's one-arg
        # first-frame grab (label_train_page.js:770, crop preview).
        return grab_frame(video_path, frame_index=frame_index)

    # ------------------------------------------------------------------
    # Visualization
    # ------------------------------------------------------------------

    def _latest_outputs_csv(self, video_path: str) -> Optional[tuple]:
        """(csv_path, model_name) of the newest outputs CSV for a video, any
        model (reference: visualize_page.py:36-48 picks by mtime)."""
        stem = os.path.splitext(os.path.basename(video_path))[0]
        rec_dir = os.path.dirname(video_path)
        try:
            listing = os.listdir(rec_dir)
        except OSError:
            return None
        # A bare startswith would also match sibling videos' outputs: the
        # augmentation sibling ("x_aug_<model>_outputs.csv" for video x) and
        # any longer-stem sibling ("trial1_retake_<model>_outputs.csv" for
        # trial1). Apply stitch_outputs' two guards (app/visualize.py): skip
        # when the remainder is an aug sibling's, or when a LONGER known
        # video/H5 stem owns the file.
        sib_stems = {f[:-4] for f in listing if f.endswith(".mp4")} | {
            f[: -len("_cls.h5")] for f in listing if f.endswith("_cls.h5")
        }
        sib_stems.discard(stem)
        prefix = stem + "_"
        csvs = []
        for f in listing:
            if not (f.startswith(prefix) and f.endswith(OUTPUTS_SUFFIX)):
                continue
            rest = f[len(prefix) : -len(OUTPUTS_SUFFIX)]
            if not rest or rest.startswith("aug_"):
                continue
            if any(
                len(vs) > len(stem) and f.startswith(vs + "_") for vs in sib_stems
            ):
                continue
            csvs.append(os.path.join(rec_dir, f))
        if not csvs:
            return None
        latest = max(csvs, key=os.path.getmtime)
        model = os.path.basename(latest)[len(stem) + 1 : -len(OUTPUTS_SUFFIX)]
        return latest, model

    def get_predictions_for_video(
        self, video_path: str, model_name: Optional[str] = None
    ) -> Optional[dict]:
        """With a model: that model's outputs. Without (the reference
        frontend's one-arg shape, visualize_page.js:411): the LATEST outputs
        CSV for the video by mtime, whichever model wrote it."""
        if model_name is None:
            found = self._latest_outputs_csv(video_path)
            if found is None:
                return None
            csv, model_name = found
        else:
            csv = outputs_csv_for_h5(h5_path_for_video(video_path), model_name)
        if not os.path.exists(csv):
            return None
        df = pd.read_csv(csv)
        model = self.state.project.models.get(model_name) if self.state.project else None
        behaviors = list((model.config.get("behaviors") if model else None) or df.columns)
        return {
            "columns": list(df.columns),
            "rows": len(df),
            "csv_path": csv,
            "model_name": model_name,
            "behaviors": behaviors,
        }

    def generate_actograms(
        self,
        root_dir: str,
        subject: str,
        model: str,
        behaviors: List[str],
        framerate: float,
        binsize_minutes: int,
        start_hour: float,
        threshold: float,
        lightcycle: str,
        plot_acrophase: bool,
        task_id: int,
    ) -> Optional[dict]:
        """Stale-task-suppressed actogram generation
        (reference: backend/visualize_page.py:119-201)."""
        st = self.state
        with st.viz_lock:
            st.latest_viz_task_id = task_id
        directory = os.path.join(root_dir, subject)
        results = {}
        try:
            master_df = visualize.stitch_outputs(directory, model)
            if master_df is None:
                return None
            for behavior in behaviors:
                with st.viz_lock:
                    if st.latest_viz_task_id != task_id:
                        return None  # superseded
                acto = visualize.Actogram(
                    behavior=behavior,
                    framerate=framerate,
                    start=start_hour,
                    binsize_minutes=binsize_minutes,
                    threshold=threshold,
                    lightcycle=lightcycle,
                    plot_acrophase=plot_acrophase,
                    preloaded_df=master_df,
                    model=model,
                )
                if acto.blob:
                    results[behavior] = acto.blob
        except Exception as e:
            # our frontend surfaces the RPC error; the reference page listens
            # for this event instead (visualize_page.py:166-173)
            st.callbacks.emit(
                "showErrorOnVisualizePage", f"Failed to generate actograms: {e}"
            )
            raise
        with st.viz_lock:
            if st.latest_viz_task_id == task_id:
                # task_id rides along for the reference page's own stale
                # check (visualize_page.js:126); our frontend ignores it
                st.callbacks.emit("updateActogramDisplay", results, task_id)
                return results
        return None

    def generate_and_save_data(
        self,
        root_dir: str,
        subject: str,
        model: str,
        behaviors: List[str],
        framerate: float,
        binsize_minutes: int,
        threshold: float,
        out_dir: Optional[str] = None,
        _ref_threshold: Optional[float] = None,
    ) -> Optional[str]:
        if _ref_threshold is not None:
            # The reference frontend's 9-positional shape
            # (visualize_page.js:347 / visualize_page.py:203): (out_dir,
            # session, subject, model, behaviors, framerate, binsize,
            # start_hour, threshold). start_hour only shifts the actogram
            # PLOT, never the binned counts (cbas.py:999 bins from frame 0),
            # so it is accepted and dropped; threshold arrives as a 0-100
            # percentage (the reference divides by 100).
            out_dir, session, subject, model, behaviors = (
                root_dir, subject, model, behaviors, framerate)
            framerate, binsize_minutes = float(binsize_minutes), int(threshold)
            threshold = float(_ref_threshold) / 100.0
            root_dir = (
                os.path.join(self.state.project.recordings_dir, session)
                if self.state.project else session
            )
        directory = os.path.join(root_dir, subject)
        df = visualize.stitch_outputs(directory, model)
        if df is None:
            return None
        out_dir = out_dir or directory
        out_path = os.path.join(out_dir, visualize.binned_export_filename(subject, model))
        return visualize.export_binned_csv(
            df, behaviors, framerate, binsize_minutes, threshold, out_path
        )

    def read_text_file(self, path: str) -> Optional[str]:
        """Contents of a PROJECT-INTERNAL text artifact (e.g. an export the
        desktop shell re-saves via its native dialog). Paths outside the
        project root resolve to None — this is reachable from the wire, so
        it must not be a general file-read primitive."""
        if not self.state.project:
            return None
        root = os.path.realpath(self.state.project.path)
        real = os.path.realpath(path)
        if not real.startswith(root + os.sep):
            return None
        try:
            with open(real, "r", encoding="utf-8") as f:
                return f.read()
        except (OSError, UnicodeDecodeError):
            return None

    def generate_ethogram(self, path: str, framerate: float = 10.0):
        """(csv_path, framerate) -> base64 PNG (our UI). A VIDEO path — the
        reference frontend's one-arg shape (visualize_page.js:438 /
        visualize_page.py:402) — resolves the newest outputs CSV for that
        video and returns the reference's {"name", "blob"} dict."""
        if path.endswith(".mp4"):
            found = self._latest_outputs_csv(path)
            if found is None or not os.path.exists(found[0]):
                return None
            df = pd.read_csv(found[0])
            blob = visualize.ethogram_blob(
                df, list(df.columns), framerate,
                title=f"Ethogram for: {os.path.basename(path)}",
            )
            return {"name": os.path.basename(path), "blob": blob} if blob else None
        if not os.path.exists(path):
            return None
        df = pd.read_csv(path)
        behaviors = list(df.columns)
        return visualize.ethogram_blob(df, behaviors, framerate)


def bind_eel(api: Api) -> bool:
    """Expose every public Api method through Eel (when installed)."""
    try:
        import eel
    except ImportError:
        return False
    for name in dir(api):
        if name.startswith("_"):
            continue
        fn = getattr(api, name)
        if callable(fn):
            eel._expose(name, fn)
    return True


def _adapt_label_payload(args: tuple):
    """Our rich labeling payload -> the reference's four receiver calls.

    The reference render loop pushes updateLabelImageSrc(main, timeline,
    zoom, activeBehavior) plus updateFileInfo / setConfirmationModeUI /
    updateLabelingStats per behavior (backend/label_train_page.py render_image
    path); our session emits ONE payload dict that our frontend draws
    client-side. The bridge re-renders the raster strips server-side
    (raster_to_blob) so the reference page shows real timeline images."""
    from cbas_tpu_torch.app.labeling import raster_to_blob

    (p,) = args
    colors = p.get("colors") or []
    total = max(1, p.get("total_frames") or 1)
    frac = (p.get("frame_index") or 0) / total
    zoom_lo, zoom_hi = p.get("zoom_start", 0.0), p.get("zoom_end", total)
    zoom_frac = None
    if zoom_hi > zoom_lo and zoom_lo <= (p.get("frame_index") or 0) < zoom_hi:
        zoom_frac = ((p.get("frame_index") or 0) - zoom_lo) / (zoom_hi - zoom_lo)
    pending = p.get("pending") or {}
    behaviors = p.get("behaviors") or []
    ptype = pending.get("type")
    active = (
        behaviors[ptype] if isinstance(ptype, int) and 0 <= ptype < len(behaviors) else None
    )
    out = [
        (
            "updateLabelImageSrc",
            (
                p.get("frame"),
                raster_to_blob(p.get("timeline") or [-1], colors, frac),
                raster_to_blob(p.get("zoom_timeline") or [-1], colors, zoom_frac),
                active,
            ),
        ),
        ("updateFileInfo", (p.get("video_name") or "",)),
        ("setConfirmationModeUI", (bool(p.get("confirmation_mode")),)),
    ]
    counts = p.get("counts") or {}
    insts = p.get("instance_counts") or {}
    for b in behaviors:
        out.append(("updateLabelingStats", (b, insts.get(b, 0), counts.get(b, 0))))
    return out


# Emission-shape adapters for receivers whose reference signature differs
# from our event payloads: our-event-name -> fn(args) -> [(js_name, args)].
_EEL_ADAPTERS = {
    # ours: (done, total, pct); reference: one status object
    # (frontend/js/global.js:22, backend/workthreads.py:298-314)
    "update_global_encoding_progress": lambda a: [
        (
            "update_global_encoding_progress",
            (
                {
                    "overall_processed": a[0],
                    "overall_total": a[1],
                    "current_percent": a[2],
                },
            ),
        )
    ],
    # ours: ({behavior: blob}, task_id); reference: ([{name, blob}], taskId)
    # (frontend/js/visualize_page.js:126)
    "updateActogramDisplay": lambda a: [
        (
            "updateActogramDisplay",
            (
                [{"name": k, "blob": v} for k, v in (a[0] or {}).items()],
                a[1] if len(a) > 1 else 0,
            ),
        )
    ],
    # ours: one payload dict; reference: four distinct receivers
    "updateLabelImageSrc": _adapt_label_payload,
    # ours: "log_line"; reference: update_log_panel(message)
    # (frontend/js/global.js:72, backend/app.py:400-409)
    "log_line": lambda a: [("update_log_panel", (a[0],))],
}


def bridge_callbacks_to_eel(api: Api, eel_module=None):
    """Forward every worker Callbacks emission to the JS side.

    The reference workers call ``eel.<jsFunc>(args)()`` directly
    (backend/workthreads.py, backend/label_train_page.py); here the workers
    emit through the transport-agnostic ``Callbacks`` fan-out, and this
    listener completes the bridge so the reference ``frontend/js/*`` pages —
    which register their receivers via JS-side ``eel.expose`` — receive the
    same ``update_global_encoding_progress`` / ``updateLabelImageSrc`` / ...
    calls in their expected shapes (``_EEL_ADAPTERS`` translates the events
    whose payloads differ; everything else forwards verbatim). Returns the
    registered listener (callers can ``callbacks.remove_listener`` it).
    """
    if eel_module is None:
        import eel as eel_module

    def forward(name: str, args: tuple) -> None:
        adapter = _EEL_ADAPTERS.get(name)
        try:
            forwards = adapter(args) if adapter else [(name, args)]
        except Exception as e:  # a malformed payload must never kill a worker
            print(f"Eel adapter '{name}' failed: {e}")
            return
        for js_name, js_args in forwards:
            js_fn = getattr(eel_module, js_name, None)
            if js_fn is None:
                continue  # not a JS-exposed function (e.g. server-internal)
            try:
                # eel.<fn>(*args) returns a handle; calling it dispatches
                # without waiting for a JS return value (fire-and-forget,
                # like the reference's ``eel.updateLabelImageSrc(blob)()``).
                js_fn(*js_args)()
            except Exception as e:  # a dead websocket must never kill a worker
                print(f"Eel callback '{js_name}' failed: {e}")

    api.state.callbacks.add_listener(forward)
    return forward
