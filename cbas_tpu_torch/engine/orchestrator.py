"""Training orchestration: runs x trials, test evaluation, artifact bundle.

Port of ``cbas_tpu/engine/orchestrator.py`` with the engine imports pointed
at ``cbas_tpu_torch``: per run a fresh subject split; per trial a fresh head
training on ``device``; best-of-trials by validation F1; optional held-out
test evaluation per run; the overall best model is calibrated, saved as a
bundle, and documented with an auditable performance_report.yaml, plot
suite, and dataset-card metric updates, as the JAX job writes them. The
project, splits, config, HDF5 store and plots are the JAX package's own
framework-free modules.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
from typing import Callable, List, Optional

import numpy as np
import pandas as pd
import yaml

from cbas_tpu.core.config import TrainingConfig, dump_yaml, load_yaml
from cbas_tpu.core.hdf5_store import global_handle_cache
from cbas_tpu.core.project import Dataset, Project
from cbas_tpu.core.splits import RandomSplitProvider, SplitProvider, subject_of
from cbas_tpu.engine.plots import (
    plot_epoch_metric,
    plot_run_metrics,
    save_confusion_matrix_plot,
)
from cbas_tpu.utils.logging import log_message
from cbas_tpu_torch.engine.calibrate import fit_temperature
from cbas_tpu_torch.engine.classifier import DELTAS_ARCH, ClassifierBundle
from cbas_tpu_torch.engine.data import (
    WindowSource,
    build_manifest,
    compute_class_weights,
    instances_for_subjects,
)
from cbas_tpu_torch.engine.evaluate_split import evaluate_params_on_manifest
from cbas_tpu_torch.engine.metrics import f1_of
from cbas_tpu_torch.engine.train import train_head
from cbas_tpu_torch.utils.naming import canonical_encoder_identity


def _safe_git_hash() -> str:
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
            )
            .decode()
            .strip()
        )
    except Exception:
        return "unknown"


def _lib_versions() -> dict:
    out = {}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception:
            pass
    return out


def run_training_job(
    project: Project,
    task: TrainingConfig,
    cancel_event: Optional[threading.Event] = None,
    split_provider: Optional[SplitProvider] = None,
    output_dir: Optional[str] = None,
    plot_suffix: str = "runs",
    progress_callback: Optional[Callable[[str], None]] = None,
    seed: Optional[int] = None,
    generate_disagreements: bool = False,
    mesh=None,
    device="cuda",
) -> Optional[str]:
    """Execute a full training task on ``device``; returns the saved model
    dir or None. ``mesh`` must be None: the port trains on one device."""
    cancel_event = cancel_event or threading.Event()
    progress = progress_callback or (lambda msg: None)
    dataset = project.datasets.get(task.name)
    if dataset is None:
        log_message(f"Dataset '{task.name}' not found.", "ERROR")
        return None

    if split_provider is None:
        split_provider = RandomSplitProvider(
            seed=seed, split_ratios=default_split_ratios(task)
        )

    all_instances = [
        inst
        for b in task.behaviors
        for inst in dataset.labels.get("labels", {}).get(b, [])
    ]
    all_subjects = list({subject_of(i) for i in all_instances})

    overall_best = None  # (params, f1, reports_history, best_epoch)
    overall_best_f1 = -1.0
    all_run_reports: List[dict] = []
    best_run_history = None
    split_assignments: dict = {}
    last_val_insts: List[dict] = []
    best_train_insts: List[dict] = []

    try:
        for run in range(task.num_runs):
            if cancel_event.is_set():
                break
            log_message(f"--- Starting Run {run + 1}/{task.num_runs} ---")
            train_subj, val_subj, test_subj = split_provider.get_split(
                run, all_subjects, all_instances, task.behaviors, allow_relaxed_fallback=True
            )
            train_insts = instances_for_subjects(all_instances, train_subj)
            val_insts = instances_for_subjects(all_instances, val_subj)
            test_insts = instances_for_subjects(all_instances, test_subj)

            seq = task.sequence_length
            train_manifest = build_manifest(project.path, train_insts, seq, task.behaviors)
            val_manifest = build_manifest(project.path, val_insts, seq, task.behaviors)
            # Test windows are only evaluated under use_test; building the
            # manifest scans every test-subject H5 per run, so skip otherwise.
            test_manifest = (
                build_manifest(project.path, test_insts, seq, task.behaviors)
                if task.use_test else []
            )
            if not train_manifest:
                log_message(
                    f"Run {run + 1}: empty training set after manifest build; skipping.",
                    "WARN",
                )
                continue
            # Preload embeddings into RAM: gathers become memcpy instead of
            # per-window HDF5 reads (labeled training sets are far smaller
            # than host memory).
            train_src = WindowSource(train_manifest, seq, preload=True)
            val_src = WindowSource(val_manifest, seq, preload=True) if val_manifest else None

            weights = None
            if task.training_method == "weighted_loss":
                weights = compute_class_weights(train_insts, task.behaviors)
            elif task.training_method == "custom_weights" and task.custom_weights:
                weights = np.array(
                    [task.custom_weights.get(b, 1.0) for b in task.behaviors], np.float32
                )

            run_best = None
            run_best_f1 = -1.0
            run_best_history = None
            run_best_epoch = -1
            for trial in range(task.num_trials):
                if cancel_event.is_set():
                    break
                progress(
                    f"Run {run + 1}/{task.num_runs}, Trial {trial + 1}/{task.num_trials}..."
                )
                params, reports, best_epoch = train_head(
                    train_src,
                    val_src,
                    seq,
                    task.behaviors,
                    cancel_event=cancel_event,
                    batch_size=task.batch_size,
                    lr=task.learning_rate,
                    epochs=task.epochs,
                    class_weights=weights,
                    patience=task.patience,
                    progress_callback=progress,
                    optimization_target=task.optimization_target,
                    weight_decay=task.weight_decay,
                    label_smoothing=task.label_smoothing,
                    lstm_hidden_size=task.lstm_hidden_size,
                    lstm_layers=task.lstm_layers,
                    seed=(seed or 0) + run * 1000 + trial,
                    mesh=mesh,
                    device=device,
                )
                if params is None or not reports or best_epoch < 0:
                    continue
                f1 = (
                    f1_of(reports[best_epoch].val_report, task.optimization_target)
                    if reports[best_epoch].val_report
                    else -1.0
                )
                if f1 > run_best_f1 or run_best is None:
                    run_best, run_best_f1 = params, f1
                    run_best_history, run_best_epoch = reports, best_epoch

            if cancel_event.is_set():
                break
            if run_best is None:
                continue

            winner = {
                "best_epoch": run_best_epoch,
                "validation_report": run_best_history[run_best_epoch].val_report
                if run_best_history
                else {},
                "validation_cm": run_best_history[run_best_epoch].val_cm
                if run_best_history
                else np.array([]),
                "test_report": {},
                "test_cm": np.array([]),
            }
            if task.use_test and test_manifest:
                log_message(f"Run {run + 1}: evaluating best model on held-out test set...")
                res = evaluate_params_on_manifest(
                    run_best, task, test_manifest, batch_size=task.batch_size,
                    device=device,
                )
                winner["test_report"], winner["test_cm"] = res["report"], res["cm"]
            all_run_reports.append(winner)

            if run_best_f1 > overall_best_f1 or overall_best is None:
                log_message(
                    f"New overall best model in Run {run + 1} (val F1 {run_best_f1:.4f})"
                )
                overall_best, overall_best_f1 = run_best, run_best_f1
                best_run_history = run_best_history
                split_assignments = {
                    "master_seed": getattr(split_provider, "initial_seed", "N/A"),
                    "train_groups": sorted(train_subj),
                    "val_groups": sorted(val_subj),
                    "test_groups": sorted(test_subj),
                }
                last_val_insts = val_insts
                best_train_insts = train_insts

        if cancel_event.is_set():
            log_message(f"Training for '{task.name}' cancelled.", "WARN")
            return None
        if overall_best is None or not all_run_reports:
            log_message(f"Training failed for '{task.name}': no valid model.", "ERROR")
            return None

        model_dir = _save_results(
            project,
            task,
            dataset,
            overall_best,
            all_run_reports,
            best_run_history,
            split_assignments,
            last_val_insts,
            output_dir=output_dir,
            plot_suffix=plot_suffix,
            device=device,
        )
        if model_dir and generate_disagreements and best_train_insts:
            try:
                bundle = ClassifierBundle.load(model_dir)
                generate_disagreement_report(
                    project, task, bundle, best_train_insts, device=device
                )
            except Exception as e:
                log_message(f"Disagreement report failed: {e}", "WARN")
        return model_dir
    finally:
        global_handle_cache.close_all()


def _save_results(
    project: Project,
    task: TrainingConfig,
    dataset: Dataset,
    best_params: dict,
    all_run_reports: List[dict],
    best_run_history,
    split_assignments: dict,
    val_insts: List[dict],
    output_dir: Optional[str] = None,
    plot_suffix: str = "runs",
    device="cuda",
) -> str:
    output_dir = output_dir or dataset.path
    os.makedirs(output_dir, exist_ok=True)
    model_name = f"{task.name}_model"
    # Default runs install the production bundle; experiment runs (sweep
    # combos, evaluate replicates, final fit — anything with its own
    # output_dir) keep their bundle INSIDE that output_dir. Parallel sweep
    # workers would otherwise race on the shared production path and a live
    # ClassifyWorker could hot-reload a torn bundle mixing two combos'
    # weights and config. (The reference clobbers the production model on
    # every sweep combo, sweep_runner.py:307-316; promotion of the final
    # model is explicit here — sweep.train_final_model installs the bundle.)
    if output_dir == dataset.path:
        model_dir = os.path.join(project.models_dir, model_name)
    else:
        model_dir = os.path.join(output_dir, model_name)

    # Temperature calibration on the best model's validation split.
    val_manifest = build_manifest(
        project.path, val_insts, task.sequence_length, task.behaviors
    )
    temperature = 1.0
    if val_manifest:
        log_message("Calibrating model temperature on validation set...")
        bundle_cfg = ClassifierBundle(
            name=model_name,
            behaviors=list(task.behaviors),
            seq_len=task.sequence_length,
            params=best_params,
            lstm_hidden_size=task.lstm_hidden_size,
            lstm_layers=task.lstm_layers,
        ).head_config()
        temperature = fit_temperature(
            best_params, bundle_cfg,
            # preload: calibration sweeps the whole val set once per logit
            # collection; lazy per-window HDF5 reads would re-read each row
            # ~seq_len times through the handle cache.
            WindowSource(val_manifest, task.sequence_length, preload=True),
            batch_size=task.batch_size,
            device=device,
        )
        log_message(f"Optimal temperature: {temperature:.4f}")

    bundle = ClassifierBundle(
        name=model_name,
        behaviors=list(task.behaviors),
        seq_len=task.sequence_length,
        params=best_params,
        architecture=DELTAS_ARCH,
        lstm_hidden_size=task.lstm_hidden_size,
        lstm_layers=task.lstm_layers,
        temperature=temperature,
        encoder_identifier=canonical_encoder_identity(project.encoder_model_identifier),
    )
    bundle.save(
        model_dir,
        extra_meta={
            "cbas_commit_hash": _safe_git_hash(),
            "training_run_info": {
                "num_runs": task.num_runs,
                "optimization_target": task.optimization_target,
            },
        },
    )

    # Auditable performance report (reference: workthreads.py:889-925).
    full_report = {
        "dataset_name": task.name,
        "model_name": model_name,
        "training_parameters": {
            "num_runs": task.num_runs,
            "num_trials": task.num_trials,
            "epochs": task.epochs,
            "learning_rate": task.learning_rate,
            "sequence_length": task.sequence_length,
            "optimization_target": task.optimization_target,
            "temperature": temperature,
            "weight_decay": task.weight_decay,
            "label_smoothing": task.label_smoothing,
            "lstm_hidden_size": task.lstm_hidden_size,
            "lstm_layers": task.lstm_layers,
            # beyond the reference report: the class-balance strategy is a
            # training parameter too — without it a custom_weights run is
            # not reproducible from its own artifact
            "training_method": task.training_method,
            "custom_weights": task.custom_weights,
        },
        "reproducibility_info": {
            "cbas_git_commit": _safe_git_hash(),
            "library_versions": _lib_versions(),
            "master_seed": split_assignments.get("master_seed"),
        },
        "split_information": {
            "train_subjects": split_assignments.get("train_groups", []),
            "validation_subjects": split_assignments.get("val_groups", []),
            "test_subjects": split_assignments.get("test_groups", []),
        },
        "run_results": all_run_reports,
    }

    def numpy_dumper(data):
        if isinstance(data, np.integer):
            return int(data)
        if isinstance(data, np.floating):
            return float(data)
        if isinstance(data, np.ndarray):
            return data.tolist()
        return str(data)

    report_path = os.path.join(output_dir, "performance_report.yaml")
    with open(report_path, "w", encoding="utf-8") as f:
        yaml.dump(
            json.loads(json.dumps(full_report, default=numpy_dumper)),
            f,
            allow_unicode=True,
            default_flow_style=False,
            sort_keys=False,
        )

    # Plot suite (reference: workthreads.py:927-957).
    best_run_idx = int(
        np.argmax(
            [
                f1_of(r.get("validation_report", {}), task.optimization_target)
                for r in all_run_reports
            ]
        )
    )
    best_run = all_run_reports[best_run_idx]
    val_cm = np.array(best_run.get("validation_cm", []))
    if val_cm.size:
        save_confusion_matrix_plot(
            val_cm,
            os.path.join(output_dir, "confusion_matrix_validation_BEST.png"),
            labels=task.behaviors,
            title="Best Run: Validation Confusion Matrix",
        )
    test_cm = np.array(best_run.get("test_cm", []))
    if test_cm.size:
        save_confusion_matrix_plot(
            test_cm,
            os.path.join(output_dir, "confusion_matrix_test_FINAL.png"),
            labels=task.behaviors,
            title="Final Model: Held-Out Test Confusion Matrix",
        )
    if best_run_history:
        for metric in ("f1-score", "precision", "recall"):
            plot_epoch_metric(best_run_history, metric, task.behaviors, output_dir)
    test_reports = [r.get("test_report", {}) for r in all_run_reports]
    if any(test_reports):
        plot_run_metrics(test_reports, task.behaviors, output_dir, plot_suffix)

    # Dataset-card metrics block (reference: workthreads.py:959-1020).
    if os.path.normpath(output_dir) == os.path.normpath(dataset.path):
        _update_dataset_card(dataset, task, all_run_reports[best_run_idx], model_name)

    project.reload()
    log_message(f"Training for '{task.name}' complete; artifacts saved to {model_dir}.")
    return model_dir


def _update_dataset_card(
    dataset: Dataset, task: TrainingConfig, best_run: dict, model_name: str
) -> None:
    val_rep = best_run.get("validation_report", {})
    test_rep = best_run.get("test_report", {})

    dataset.config = load_yaml(dataset.config_path)
    for b in task.behaviors:
        v = val_rep.get(b, {})
        t = test_rep.get(b, {})
        dataset.set_metric(b, "Precision", round(float(v.get("precision", 0.0)), 2))
        dataset.set_metric(b, "Recall", round(float(v.get("recall", 0.0)), 2))
        dataset.set_metric(b, "F1 Score", round(float(v.get("f1-score", 0.0)), 2))
        dataset.set_metric(
            b, "Test F1",
            "N/A" if not task.use_test else round(float(t.get("f1-score", 0.0)), 2),
        )
    dataset.config["state"] = "trained"
    dataset.config["trained_model"] = model_name
    # The instance/frame counts come from ONE implementation of the fixed
    # seed-42 80/0/20 card split (project.py) — a second inline copy here
    # drifted from it would make card numbers depend on which code path
    # last wrote them. This also dumps the config.
    dataset.update_instance_counts_in_config()


def default_split_ratios(task: TrainingConfig) -> tuple:
    """(train, val, test) subject ratios for a training job. Only reserve the
    test fraction when a test split is actually used — otherwise the reserved
    subjects would silently fall into validation (splits.py gives validation
    all leftovers at test ratio 0), cutting training to 65% of subjects."""
    test = task.test_split if task.use_test else 0.0
    return (1.0 - test - 0.15, 0.15, test)


def generate_disagreement_report(
    project: Project,
    task: TrainingConfig,
    bundle: ClassifierBundle,
    train_insts: List[dict],
    device="cuda",
) -> str:
    """Find contiguous blocks where the model contradicts human labels, sorted
    by model confidence (reference: backend/workthreads.py:728-811)."""
    from cbas_tpu_torch.engine.infer import InferenceSession
    from cbas_tpu.utils.naming import (
        h5_path_for_video,
        outputs_csv_for_h5,
        outputs_csv_is_stale,
    )

    disagreements = []
    by_video: dict = {}
    for inst in train_insts:
        v = inst.get("video")
        if v:
            by_video.setdefault(str(v), []).append(inst)

    session = None
    for rel_video, insts in by_video.items():
        h5_path = h5_path_for_video(os.path.join(project.path, rel_video))
        if not os.path.exists(h5_path):
            continue
        # The saved model is named f"{task.name}_model" (run_training_job):
        # reuse its outputs only when they were written by THIS model
        # version (CSV newer than the saved weights) — after a retrain, a
        # stale CSV would make the report audit the previous model. Fresh
        # ones are written under the same model name so they don't
        # masquerade as a phantom model called task.name.
        csv_path = outputs_csv_for_h5(h5_path, f"{task.name}_model")
        model_dir = os.path.join(project.models_dir, f"{task.name}_model")
        if outputs_csv_is_stale(csv_path, model_dir):
            if session is None:
                session = InferenceSession(bundle, device=device)
            csv_path = session.infer_h5(h5_path, output_csv=csv_path)
            if not csv_path:
                continue
        try:
            df = pd.read_csv(csv_path)
            df["model_label"] = df[list(task.behaviors)].idxmax(axis=1)
            df["model_confidence"] = df[list(task.behaviors)].max(axis=1)
        except Exception as e:
            log_message(f"Could not process {csv_path}: {e}", "WARN")
            continue

        for inst in insts:
            try:
                start, end = int(inst["start"]), int(inst["end"])
                true_label = inst["label"]
            except (KeyError, ValueError):
                continue
            window = df.iloc[start : end + 1]
            errors = window[window["model_label"] != true_label]
            if errors.empty:
                continue
            blocks = (errors.index.to_series().diff() != 1).cumsum()
            for _, block in errors.groupby(blocks):
                disagreements.append(
                    {
                        "video_path": rel_video,
                        "start_frame": int(block.index.min()),
                        "end_frame": int(block.index.max()),
                        "human_label": true_label,
                        "model_prediction": block["model_label"].mode()[0],
                        "model_confidence": float(block["model_confidence"].mean()),
                    }
                )

    disagreements.sort(key=lambda d: d["model_confidence"], reverse=True)
    dataset = project.datasets[task.name]
    report_path = os.path.join(dataset.path, "disagreement_report.yaml")
    dump_yaml(disagreements, report_path)
    log_message(f"Disagreement report with {len(disagreements)} items saved.")
    return report_path
