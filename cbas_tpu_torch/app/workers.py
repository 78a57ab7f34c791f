"""Background workers: encode, classify, train — the host-side job scheduler.

The reference runs three daemon threads over lock-guarded task lists with
CUDA streams for overlap (backend/workthreads.py:267-533,536-726). Here the
device work is queued on the device's current stream; the workers pump
queues, push progress through the Callbacks fan-out, and chain encode ->
live classification exactly like the reference.

Callback names (UI contract):
    update_global_encoding_progress(done, total, percent)
    updateInferenceProgress(model, percent, message)
    updateTrainingStatusOnUI(dataset, message)
    notify_new_data_available()
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import List, Optional

from cbas_tpu_torch.app.state import AppState
from cbas_tpu_torch.core.config import EncodeConfig, InferenceConfig, TrainingConfig
from cbas_tpu_torch.engine.classifier import ClassifierBundle
from cbas_tpu_torch.engine.infer import InferenceSession
from cbas_tpu_torch.engine.orchestrator import run_training_job
from cbas_tpu_torch.utils.logging import log_message


class EncodeWorker(threading.Thread):
    """Drains the encode queue through the device encoder; chains into live
    classification when a live model is selected."""

    def __init__(self, state: AppState, poll_s: float = 1.0, config: Optional[EncodeConfig] = None):
        super().__init__(daemon=True, name="EncodeWorker")
        self.state = state
        self.poll_s = poll_s
        self._config = config

    @property
    def config(self) -> EncodeConfig:
        """Explicit config wins; else the loaded project's ``encode:`` YAML
        section (where e.g. reuse_threshold is set per deployment)."""
        if self._config is not None:
            return self._config
        if self.state.project is not None:
            return self.state.project.settings.encode
        return EncodeConfig()

    def process_one(self) -> bool:
        path = self.state.encode_tasks.pop()
        if path is None:
            return False
        st = self.state
        if st.encoder is None:
            # Rate-limit: without an encoder this fires every poll forever.
            now = time.monotonic()
            if now - getattr(self, "_no_encoder_logged", 0.0) > 30.0:
                log_message("No encoder loaded; re-queueing encode task.", "WARN")
                self._no_encoder_logged = now
            st.encode_tasks.append(path)
            # run() waits poll_s on the shutdown event next (interruptible);
            # an uninterruptible sleep here would delay kill_all_processes'
            # bounded join and double the idle poll.
            return False
        try:
            # Imported here: the encode path needs h5py, which the app does
            # not need to start.
            from cbas_tpu_torch.engine.encode import encode_file

            def per_file_progress(pct: float) -> None:
                done, total = st.encode_progress()
                st.callbacks.emit("update_global_encoding_progress", done, total, pct)

            out = encode_file(
                st.encoder, path, progress_callback=per_file_progress,
                config=self.config,
                # shutdown interrupts an in-flight encode at the next batch
                # boundary — without it, kill_all_processes' bounded join
                # times out on hour-long videos and a subsequent
                # load_project would race a still-running worker
                cancel_event=st.shutdown,
            )
            st.note_encode_done()
            done, total = st.encode_progress()
            st.callbacks.emit("update_global_encoding_progress", done, total, 100.0)
            if out and st.live_inference_model_name:
                from cbas_tpu_torch.ingest.standardize import is_aug_video

                # Same exclusion as Api.start_classification: augmentation
                # siblings get encoded (training needs their embeddings) but
                # nothing consumes their predictions — don't chain them into
                # live classification.
                if not is_aug_video(path):
                    st.classify_tasks.append(out)
            return True
        except Exception as e:
            st.note_encode_done()
            log_message(f"Encoding failed for '{path}': {e}", "ERROR")
            traceback.print_exc()
            # the failure still advances the batch — without this the global
            # overlay freezes below 100% when the last queued file fails
            done, total = st.encode_progress()
            st.callbacks.emit("update_global_encoding_progress", done, total, 100.0)
            return False

    def run(self) -> None:
        while not self.state.shutdown.is_set():
            if not self.process_one():
                self.state.shutdown.wait(self.poll_s)


class ClassifyWorker(threading.Thread):
    """Watches the live model selection, (re)loads its bundle, drains the
    classify queue through a reusable compiled InferenceSession."""

    def __init__(self, state: AppState, poll_s: float = 1.0, config: Optional[InferenceConfig] = None):
        super().__init__(daemon=True, name="ClassifyWorker")
        self.state = state
        self.poll_s = poll_s
        self.config = config or InferenceConfig()
        self._session: Optional[InferenceSession] = None
        self._loaded_model: Optional[str] = None
        self._loaded_sig: tuple = ()
        self._reload_retries = 0
        self._batch_total = 0
        self._batch_done = 0

    @staticmethod
    def _bundle_sig(model_dir: str) -> tuple:
        """On-disk identity of a bundle (mtime+size of each artifact) — the
        hot-reload trigger. Taken BEFORE a load, so a write that races the
        load re-triggers the check on the next poll instead of being lost."""
        sig = []
        for fname in ("model.npz", "model.pth", "model_meta.json", "config.yaml"):
            try:
                s = os.stat(os.path.join(model_dir, fname))
                sig.append((fname, s.st_mtime_ns, s.st_size))
            except OSError:
                sig.append((fname, 0, 0))
        return tuple(sig)

    def _hot_reload_if_stale(self) -> bool:
        """Reload the live bundle when its files changed on disk (a retrain
        under the same name — ClassifierBundle.save()'s meta-first/weights-
        last ordering exists exactly for this reader). Without it, live
        inference serves the PRE-retrain weights forever while stamping
        output CSVs with the model's name. The reference has the same
        staleness (workthreads.py:462-471 reloads only on name change);
        documented deviation, fail-safe direction.

        Returns True when classification must HOLD this poll (a reload
        failed, likely torn mid-save; retry next poll rather than serving
        stale weights or double-failing through the name-change path)."""
        st = self.state
        name = self._loaded_model
        # No session check: after a failed reload _session is None while
        # _loaded_model still names the bundle — the next poll must retry.
        if not name or st.project is None:
            return False
        model = st.project.models.get(name)
        if model is None:
            return False
        sig = self._bundle_sig(model.path)
        if sig == self._loaded_sig:
            return False
        try:
            bundle = ClassifierBundle.load(
                model.path, expected_encoder=st.project.encoder_model_identifier
            )
            self._session = InferenceSession(bundle, self.config, mesh=st.mesh, device=st.device)
            self._loaded_sig = sig
            self._reload_retries = 0
            log_message(
                f"Model '{name}' changed on disk; live inference hot-reloaded "
                "the new weights."
            )
            return False
        except Exception as e:
            # Likely a torn mid-save read (load() raises "Retry the load.");
            # hold classification — serving the stale weights would be the
            # silent-wrong-results case this reload exists to prevent.
            self._session = None
            self._reload_retries += 1
            if self._reload_retries <= 10:
                log_message(
                    f"Model '{name}' changed on disk but reload failed ({e}); "
                    "retrying.", "WARN",
                )
            else:
                log_message(
                    f"Model '{name}' hot reload failed {self._reload_retries} "
                    f"times ({e}); dropping the batch.", "ERROR",
                )
                self._fail_batch(name, f"hot reload failed: {e}")
            return True

    def _ensure_session(self) -> Optional[InferenceSession]:
        st = self.state
        name = st.live_inference_model_name
        if name == self._loaded_model and self._hot_reload_if_stale():
            return None  # mid-save read: hold until the next poll's retry
        if name != self._loaded_model:
            if name and st.project is None:
                # Do NOT latch _loaded_model yet: a selection made before
                # load_project must retry once a project exists, not return
                # a forever-None session while tasks sit silently queued.
                now = time.monotonic()
                if now - getattr(self, "_no_project_logged", 0.0) > 30.0:
                    log_message(
                        "Live model selected but no project is loaded; "
                        "classification will start after load_project.", "WARN",
                    )
                    self._no_project_logged = now
                return None
            self._session, self._loaded_model = None, name
            self._batch_total, self._batch_done = len(st.classify_tasks), 0
            if name and st.project is not None:
                model = st.project.models.get(name)
                if model is None:
                    log_message(f"Model '{name}' not found in project.", "ERROR")
                    self._fail_batch(name, "model not found")
                    return None
                try:
                    # sig BEFORE load: a save() racing the load re-triggers
                    # the staleness check on the next poll instead of the
                    # post-race weights being mistaken for what was loaded
                    sig = self._bundle_sig(model.path)
                    bundle = ClassifierBundle.load(
                        model.path, expected_encoder=st.project.encoder_model_identifier
                    )
                    self._session = InferenceSession(bundle, self.config, mesh=st.mesh, device=st.device)
                    self._loaded_sig = sig
                    self._reload_retries = 0
                    log_message(f"Model '{name}' loaded for live inference.")
                except Exception as e:
                    log_message(f"Error loading model bundle '{name}': {e}", "ERROR")
                    self._fail_batch(name, f"model load failed: {e}")
        return self._session

    def _fail_batch(self, model_name: Optional[str], reason: str) -> None:
        """Deselect the model AND complete the batch as failed: queued tasks
        would otherwise sit silently forever (no session ever pops them) with
        the UI showing a batch that never starts."""
        st = self.state
        dropped = st.classify_tasks.drain()
        st.live_inference_model_name = None
        st.batch_classification_active = False
        self._batch_total = self._batch_done = 0
        if dropped:
            log_message(f"Dropped {dropped} queued classification task(s): {reason}", "ERROR")
        st.callbacks.emit(
            "updateInferenceProgress", model_name or "?", 100.0,
            f"Inference failed: {reason}",
        )

    def process_one(self) -> bool:
        st = self.state
        session = self._ensure_session()
        if session is None:
            return False
        # Track the batch from the live queue, not just on model change: a
        # batch for the already-loaded model (or files enqueued after the
        # name was set but before the extend landed) must still progress to
        # "Inference complete." and the project reload.
        queued = len(st.classify_tasks)
        if queued and self._batch_total <= self._batch_done:
            self._batch_total, self._batch_done = queued, 0
        else:
            self._batch_total = max(self._batch_total, self._batch_done + queued)
        path = st.classify_tasks.pop()
        if path is None:
            return False
        model_name = self._loaded_model
        log_message(f"Classifying: {path} with model '{model_name}'")
        ok = True
        try:
            # shutdown doubles as the cancel signal: an hour-long file spans
            # hundreds of device calls and the teardown join is bounded
            session.infer_h5(path, cancel_event=st.shutdown)
            st.callbacks.emit("notify_new_data_available")
        except Exception as e:
            ok = False
            log_message(f"Failed to classify '{path}': {e}", "ERROR")
            traceback.print_exc()
        # A failed file still advances the batch — otherwise _batch_done can
        # never reach _batch_total, progress sticks below 100%, the project
        # never reloads, and batch_classification_active stays latched (a
        # later live-chained segment would then satisfy the stale total and
        # deselect the live model mid-recording).
        self._batch_done += 1
        if self._batch_total:
            pct = self._batch_done / self._batch_total * 100.0
            st.callbacks.emit(
                "updateInferenceProgress", model_name, pct,
                f"Processing {self._batch_done}/{self._batch_total}"
                + ("" if ok else " (last file failed)"),
            )
            if self._batch_done >= self._batch_total and not len(st.classify_tasks):
                st.callbacks.emit(
                    "updateInferenceProgress", model_name, 100.0, "Inference complete."
                )
                if st.project is not None:
                    st.project.reload()
                # Only an explicit start_classification batch deselects the
                # live model at completion (reference queue-complete
                # semantics); live-chained segments during recording must
                # keep it selected or live inference dies after one file.
                # Re-check the selection: a start_classification that landed
                # during the project reload above (new batch, possibly a
                # different model) must not have its selection wiped.
                if (
                    st.batch_classification_active
                    and st.live_inference_model_name == model_name
                    and not len(st.classify_tasks)
                ):
                    st.batch_classification_active = False
                    st.live_inference_model_name = None
                self._batch_total = self._batch_done = 0
        return ok

    def run(self) -> None:
        while not self.state.shutdown.is_set():
            if not self.process_one():
                self.state.shutdown.wait(self.poll_s)


class TrainWorker(threading.Thread):
    """Runs queued training jobs through the orchestrator."""

    def __init__(self, state: AppState, poll_s: float = 1.0):
        super().__init__(daemon=True, name="TrainWorker")
        self.state = state
        self.poll_s = poll_s
        self._queue: List[TrainingConfig] = []
        self._lock = threading.Lock()

    def queue_task(self, task: TrainingConfig) -> None:
        # No cancel-flag clear here: a cancel aimed at the RUNNING job must
        # not be erased by queueing the next one. Each job starts with a
        # fresh flag (cleared in process_one just before the run).
        with self._lock:
            self._queue.append(task)
        log_message(f"Queued training task for dataset: {task.name}")

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def clear_queue(self) -> int:
        """Drop every queued (not-yet-running) job; returns how many.

        Cancellation semantics match the reference (workthreads.py:1069-1082):
        the cancel flag stops the RUNNING job and the queue is cleared so a
        pending job doesn't start right after — without this, cancelling a
        queued dataset killed the currently running one and then trained the
        'cancelled' dataset anyway."""
        with self._lock:
            n = len(self._queue)
            self._queue.clear()
        return n

    def process_one(self) -> bool:
        with self._lock:
            task = self._queue.pop(0) if self._queue else None
        if task is None:
            return False
        st = self.state
        # Fresh cancel flag for this job: cancellation is scoped to the job
        # that is running when the user clicks cancel.
        st.training_cancel.clear()
        # kill_all_processes sets shutdown + training_cancel together; the
        # clear above could erase a cancel that raced in between the run
        # loop's shutdown check and here, letting a multi-epoch job start
        # (and outlive the bounded join) during teardown.
        if st.shutdown.is_set():
            return False

        def progress(message: str) -> None:
            st.callbacks.emit("updateTrainingStatusOnUI", task.name, message)

        try:
            model_dir = run_training_job(
                st.project, task,
                cancel_event=st.training_cancel,
                progress_callback=progress,
                mesh=st.mesh,
                device=st.device,
            )
            if model_dir:
                progress("Training complete.")
                st.callbacks.emit("refreshAllDatasets")
            else:
                progress("Training failed or cancelled.")
            return True
        except Exception as e:
            log_message(f"Critical error during training for {task.name}: {e}", "ERROR")
            traceback.print_exc()
            progress(f"Training Error: {e}")
            return False

    def run(self) -> None:
        while not self.state.shutdown.is_set():
            if not self.process_one():
                self.state.shutdown.wait(self.poll_s)


def queue_encode_task(state: AppState, video_path: str) -> bool:
    if state.encode_tasks.append(video_path):
        state.note_encode_queued()
        return True
    return False


def sweep_stale_embeddings(state: AppState) -> int:
    """Queue every video whose H5 is missing/unstamped/mismatched
    (reference: backend/startup_page.py:82-126)."""
    if state.project is None:
        return 0
    stale = state.project.stale_or_missing_embeddings()
    n = sum(queue_encode_task(state, v) for v in stale)
    if n:
        log_message(f"Queued {n} videos for (re-)encoding after stale sweep.")
    return n


def select_live_model(state: AppState, model_name: Optional[str]) -> None:
    """Switch the live model — the ONLY sanctioned way to change the name.

    Queue items carry no model, so a still-draining batch for a DIFFERENT
    model must be superseded explicitly; otherwise its remaining files would
    silently be classified with the new model. Both entry points (batch
    start_classification and the live-inference toggle) route through here.
    """
    prev = state.live_inference_model_name
    if prev and prev != model_name:
        dropped = state.classify_tasks.drain()
        # The superseded batch is over: leaving batch_classification_active
        # latched would make a later live-chained single segment satisfy the
        # stale "batch complete" check and deselect the live model after one
        # file (_fail_batch resets it for the same reason).
        state.batch_classification_active = False
        if dropped:
            log_message(
                f"Live model switched to '{model_name}': dropped {dropped} "
                f"queued task(s) from '{prev}'s batch — re-run classification "
                f"for '{prev}' to finish them.", "WARN",
            )
            state.callbacks.emit(
                "updateInferenceProgress", prev, 100.0,
                f"Superseded by '{model_name}': {dropped} file(s) skipped.",
            )
    state.live_inference_model_name = model_name


def start_classification(state: AppState, model_name: str, h5_files: List[str]) -> int:
    """Select the live model and enqueue files lacking that model's outputs
    (reference: backend/label_train_page.py:1853-1895). "Lacking" includes
    CSVs older than the bundle's saved weights: after a same-name retrain an
    existence-only check would see every stale CSV as done, queue nothing,
    and keep presenting the previous model's predictions under the new
    model's name (same rule as Api guided labeling / the disagreement
    report, utils/naming.py outputs_csv_is_stale)."""
    from cbas_tpu_torch.utils.naming import outputs_csv_for_h5, outputs_csv_is_stale

    model = state.project.models.get(model_name) if state.project else None
    model_dir = model.path if model else ""

    def needs_infer(h5: str) -> bool:
        csv = outputs_csv_for_h5(h5, model_name)
        if not model_dir:
            return not os.path.exists(csv)
        return outputs_csv_is_stale(csv, model_dir)

    todo = [f for f in h5_files if needs_infer(f)]
    select_live_model(state, model_name)
    if todo:
        state.batch_classification_active = True
    return state.classify_tasks.extend(todo)


def start_workers(state: AppState):
    """Spawn the worker trio (daemon threads); returns them for joining."""
    workers = (EncodeWorker(state), ClassifyWorker(state), TrainWorker(state))
    for w in workers:
        w.start()
    return workers
