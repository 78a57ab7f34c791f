"""Headless hyperparameter sweep runner (4 phases).

Rebuild of the reference's sweep_runner.py: ``precompute`` writes fingerprinted
split manifests (10 sweep splits 85/15/0 + 20 outer splits 70/15/15);
``sweep`` grid-searches over the parameter grid with a constant token budget
(batch x seq_len held ~constant, snapped to multiples of 32); ``evaluate``
runs the champion parameters over every outer replicate and exports
per-behavior test P/R/F1; ``train_final`` pools train+val and trains one
deployable model, updating the dataset card from the evaluate CSV.
Determinism comes from seeded split manifests + seeded training.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import time
from datetime import datetime
from typing import Dict, List, Optional

import pandas as pd
import yaml

from cbas_tpu_torch.core.config import TrainingConfig, load_yaml, dump_yaml
from cbas_tpu_torch.core.project import Project
from cbas_tpu_torch.core.splits import (
    ManifestSplitProvider,
    RandomSplitProvider,
    SplitProvider,
    dataset_fingerprint,
    subject_of,
    write_split_manifest,
)
from cbas_tpu_torch.engine.orchestrator import run_training_job
from cbas_tpu_torch.utils.logging import log_message


def nice_multiple(x: int, base: int = 32, minimum: int = 32) -> int:
    return max(minimum, (x // base) * base)


def derive_batch_size_for_seq_len(
    seq_len: int,
    base_batch: int = 1024,
    base_seq: int = 31,
    batch_cap: int = 1024,
    minimum: int = 32,
    snap: int = 32,
) -> int:
    """Hold batch*seq_len ~constant (reference: sweep_runner.py:84-97)."""
    target_tokens = base_batch * base_seq
    raw = max(1, target_tokens // max(1, seq_len))
    return min(nice_multiple(raw, snap, minimum), batch_cap)


DEFAULT_PARAMETER_GRID: Dict[str, list] = {
    "weight_decay": [1e-4, 2e-4],
    "lstm_hidden_size": [128],
    "label_smoothing": [0.1],
    "lstm_layers": [1],
    "learning_rate": [5e-5, 7e-5],
    "sequence_length": [63, 95],
}

DEFAULT_SWEEP_FIXED: Dict[str, object] = {
    "training_method": "oversampling",
    "optimization_target": "weighted avg",
    "epochs": 10,
    "patience": 3,
    "batch_size": 1024,
    "use_test": False,
    "test_split": 0.0,
    "num_runs": 5,
    "num_trials": 2,
}

DEFAULT_CHAMPION: Dict[str, object] = {
    "weight_decay": 1e-4,
    "lstm_hidden_size": 128,
    "label_smoothing": 0.1,
    "lstm_layers": 1,
    "training_method": "oversampling",
    "optimization_target": "weighted avg",
    "learning_rate": 5e-5,
    "epochs": 10,
    "patience": 3,
    "batch_size": 1024,
    "sequence_length": 63,
    "use_test": True,
    "test_split": 0.15,
    "num_runs": 15,
    "num_trials": 2,
}


class SweepRunner:
    def __init__(
        self,
        project: Project,
        dataset_name: str,
        parameter_grid: Optional[dict] = None,
        fixed: Optional[dict] = None,
        champion: Optional[dict] = None,
        n_sweep_splits: int = 10,
        n_outer_splits: int = 20,
        seed: int = 42,
        device="cuda",
    ):
        self.project = project
        self.device = device  # where every training job of the sweep runs
        self.dataset_name = dataset_name
        self.dataset = project.datasets[dataset_name]
        self.grid = parameter_grid or DEFAULT_PARAMETER_GRID
        self.fixed = dict(DEFAULT_SWEEP_FIXED, **(fixed or {}))
        self.champion = dict(DEFAULT_CHAMPION, **(champion or {}))
        self.n_sweep_splits = n_sweep_splits
        self.n_outer_splits = n_outer_splits
        self.seed = seed
        self.experiments_dir = os.path.join(self.dataset.path, "experiments")
        os.makedirs(self.experiments_dir, exist_ok=True)

    # -- helpers -------------------------------------------------------------

    def _fingerprint(self) -> str:
        return dataset_fingerprint(self.dataset.labels.get("labels", {}))

    def _all_instances(self):
        return [
            inst
            for b in self.dataset.config.get("behaviors", [])
            for inst in self.dataset.labels.get("labels", {}).get(b, [])
        ]

    def _make_task(self, params: dict) -> TrainingConfig:
        return TrainingConfig(
            name=self.dataset_name,
            behaviors=self.dataset.config.get("behaviors", []),
            **params,
        )

    @property
    def sweep_manifest_path(self) -> str:
        return os.path.join(self.project.path, "sweep_splits.json")

    @property
    def outer_manifest_path(self) -> str:
        return os.path.join(self.project.path, "outer_splits.json")

    # -- phase 1: precompute ---------------------------------------------------

    def precompute_splits(self) -> None:
        fingerprint = self._fingerprint()
        log_message(f"Dataset fingerprint: {fingerprint}")
        instances = self._all_instances()
        subjects = list({subject_of(i) for i in instances})
        behaviors = self.dataset.config.get("behaviors", [])

        # Deliberate deviation from the reference: sweep_runner.py:220,236
        # seeds BOTH providers identically, so sweep split i's 15% validation
        # subjects are exactly outer split i's 15% test subjects (both are
        # shuffled[0.85n:] of the same seeded shuffle) — hyperparameters get
        # selected on the subjects later reported as held-out test. The outer
        # manifest here uses a disjoint seed stream.
        for path, ratios, n, mtype, seed in (
            (self.sweep_manifest_path, (0.85, 0.15, 0.0), self.n_sweep_splits,
             "hyperparameter_sweep", self.seed),
            (self.outer_manifest_path, (0.70, 0.15, 0.15), self.n_outer_splits,
             "outer_evaluation", self.seed + 100003),
        ):
            provider = RandomSplitProvider(seed=seed, split_ratios=ratios)
            splits = []
            for i in range(n):
                train, val, test = provider.get_split(
                    i, subjects, instances, behaviors, allow_relaxed_fallback=True
                )
                splits.append({"train": train, "validation": val, "test": test})
            # single source of truth for the manifest format (it must stay
            # readable by ManifestSplitProvider across both writers)
            write_split_manifest(
                path, splits, fingerprint, metadata={"manifest_type": mtype}
            )
            log_message(f"Saved {n} splits to {path}")

    # -- phase 2: sweep ---------------------------------------------------------

    def _sweep_combos(self) -> List[dict]:
        """The grid as concrete param dicts, each with its derived batch size
        and deterministic output dir — the unit of sweep parallelism."""
        keys, values = zip(*self.grid.items())
        base_batch = int(self.fixed.get("batch_size", 1024))
        combos = []
        for v in itertools.product(*values):
            grid_params = dict(zip(keys, v))
            params = dict(self.fixed)
            params.update(grid_params)
            params["batch_size"] = derive_batch_size_for_seq_len(
                seq_len=int(params["sequence_length"]),
                base_batch=base_batch,
                base_seq=31,
                batch_cap=base_batch,
            )
            param_str = "_".join(
                f"{k.replace('_', '-')}-{v}" for k, v in grid_params.items()
            )
            combos.append({
                "grid": grid_params,
                "params": params,
                "out_dir": os.path.join(self.experiments_dir, f"sweep_{param_str}"),
            })
        return combos

    def _drain_sweep_combos(self, combos: List[dict]) -> int:
        """Run every combo lacking its report; returns the number of failed
        combos. Combos are claimed via atomic lease files (utils/claims.py)
        and marked done by the combo's performance_report.yaml, so any number
        of worker processes — across chips or pod hosts — can drain the same
        grid concurrently, and an interrupted sweep resumes where it stopped
        (the fingerprinted split manifest pins the data; the dir name pins
        the params)."""
        from cbas_tpu_torch.utils.claims import (
            ClaimHeartbeat,
            release_claim_path,
            try_claim_path,
        )

        # Build the provider BEFORE claiming anything: a missing manifest
        # (sweep run before precompute) or a stale fingerprint (labels edited
        # since precompute) must abort cleanly, not leak a claimed combo for
        # the full TTL. It is loop-invariant, so parse the JSON once.
        provider = ManifestSplitProvider(self.sweep_manifest_path, self._fingerprint())
        ttl_s = 6 * 3600.0
        failed = 0
        for i, combo in enumerate(combos):
            report_path = os.path.join(combo["out_dir"], "performance_report.yaml")
            if os.path.exists(report_path):
                continue
            claim = combo["out_dir"] + ".claim"
            if not try_claim_path(claim, ttl_s=ttl_s):
                continue
            if os.path.exists(report_path):
                release_claim_path(claim)
                continue
            t0 = time.time()
            log_message(
                f"--- Sweep job {i + 1}/{len(combos)}: {combo['grid']} "
                f"(batch {combo['params']['batch_size']}) ---"
            )
            try:
                task = self._make_task(combo["params"])
                # heartbeat: a multi-hour combo must not have its LIVE lease
                # aged out under it (a second worker would write the same
                # out_dir)
                with ClaimHeartbeat(claim, ttl_s):
                    run_training_job(
                        self.project, task, split_provider=provider,
                        output_dir=combo["out_dir"], plot_suffix="runs",
                        seed=self.seed, device=self.device,
                    )
            except Exception as e:  # noqa: BLE001 — one bad combo must not stall the grid
                # Release the claim (the finally below) so a resumed/parallel
                # worker can retry immediately, and keep draining.
                failed += 1
                log_message(f"Sweep job {i + 1} ({combo['grid']}) failed: {e}", "ERROR")
                continue
            finally:
                release_claim_path(claim)
            log_message(f"--- Sweep job {i + 1} done in {time.time() - t0:.1f}s ---")
        return failed

    def _collect_sweep_results(self, combos: List[dict]) -> Optional[str]:
        results = []
        for combo in combos:
            params = combo["params"]
            report_path = os.path.join(combo["out_dir"], "performance_report.yaml")
            if not os.path.exists(report_path):
                continue
            report = load_yaml(report_path)
            runs = report.get("run_results", [])
            if not runs:
                continue
            row = dict(params)
            row["effective_tokens_per_step"] = (
                params["batch_size"] * params["sequence_length"]
            )
            target = params.get("optimization_target", "weighted avg")
            scores = [
                r.get("validation_report", {}).get(target, {}).get("f1-score", 0.0)
                for r in runs
            ]
            row[f"avg_validation_f1_{target.replace(' ', '_')}"] = (
                sum(scores) / len(scores) if scores else 0.0
            )
            results.append(row)
        if not results:
            log_message("Sweep produced no results.", "WARN")
            return None
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = os.path.join(
            self.experiments_dir, f"sweep_results_{self.dataset_name}_{ts}.csv"
        )
        pd.DataFrame(results).to_csv(out, index=False)
        log_message(f"Sweep results saved to {out}")
        return out

    def run_sweep(self, jobs: int = 1, drain_only: bool = False) -> Optional[str]:
        """Run the grid; ``jobs`` > 1 fans combos out over that many
        single-device worker processes (CUDA_VISIBLE_DEVICES binding), each
        draining the shared claim-guarded grid. ``drain_only`` is the worker
        mode: run combos, skip the results CSV (the parent collects)."""
        combos = self._sweep_combos()
        log_message(f"Sweep: {len(combos)} parameter combinations.")
        jobs = min(jobs, len(combos))
        failures = 0
        if jobs <= 1:
            failures = self._drain_sweep_combos(combos)
            if drain_only:
                if failures:
                    raise RuntimeError(f"{failures} sweep combo(s) failed")
                return None
        else:
            import subprocess
            import sys

            # Workers re-build the runner from the CLI, which defaults the
            # grid — persist THIS runner's exact configuration so they drain
            # the same combos (and multi-host workers can point --config at
            # it over the shared filesystem).
            config_path = os.path.join(self.experiments_dir, "sweep_config.json")
            with open(config_path, "w") as f:
                json.dump({
                    "parameter_grid": self.grid,
                    "fixed": self.fixed,
                    "champion": self.champion,
                    "n_sweep_splits": self.n_sweep_splits,
                    "n_outer_splits": self.n_outer_splits,
                }, f, indent=1)
            cmd = [sys.executable, "-m", "cbas_tpu_torch.app.sweep",
                   "--project_path", self.project.path,
                   "--dataset_name", self.dataset_name,
                   "--phase", "sweep", "--seed", str(self.seed),
                   "--jobs", "1", "--drain-only", "--config", config_path]
            procs = []
            for i in range(jobs):
                env = dict(os.environ)
                if str(self.device) == "cpu":
                    env["CBAS_FORCE_CPU"] = "1"  # workers train where this runner does
                elif not os.environ.get("CBAS_SWEEP_NO_CHIP_BINDING"):
                    # assign, don't setdefault: an inherited
                    # CUDA_VISIBLE_DEVICES would pin every worker to one card
                    env["CUDA_VISIBLE_DEVICES"] = str(i)
                procs.append(subprocess.Popen(cmd, env=env))
            rc = [p.wait() for p in procs]
            failures = sum(1 for c in rc if c)
            if failures:
                log_message(f"Sweep worker exit codes: {rc}", "ERROR")
        out = self._collect_sweep_results(combos)
        if failures:
            # Surface the failure to the caller/shell even when a partial CSV
            # was written — a pipeline chaining `sweep && evaluate` must not
            # pick a champion from an incompletely drained grid.
            raise RuntimeError(
                f"sweep incomplete: {failures} worker(s)/combo(s) failed"
                + (f" (partial results: {out})" if out else "")
            )
        return out

    # -- phase 3: evaluate ---------------------------------------------------------

    def run_final_evaluation(self) -> Optional[str]:
        fingerprint = self._fingerprint()
        provider = ManifestSplitProvider(self.outer_manifest_path, fingerprint)
        n_replicates = len(provider.manifest["splits"])
        params = dict(self.champion)
        params["num_runs"] = min(int(params.get("num_runs", n_replicates)), n_replicates)
        task = self._make_task(params)
        out_dir = os.path.join(
            self.experiments_dir,
            f"final_evaluation_{datetime.now().strftime('%Y%m%d_%H%M%S')}",
        )
        run_training_job(
            self.project, task, split_provider=provider, output_dir=out_dir,
            plot_suffix="replicates", seed=self.seed, device=self.device,
        )

        report_path = os.path.join(out_dir, "performance_report.yaml")
        if not os.path.exists(report_path):
            return None
        report = load_yaml(report_path)
        rows = []
        target = params.get("optimization_target", "weighted avg")
        for i, run in enumerate(report.get("run_results", [])):
            row = dict(self.champion)
            row["replicate"] = i + 1
            test = run.get("test_report", {}) or {}
            for b in task.behaviors:
                m = test.get(b, {})
                row[f"{b}_Test_F1"] = m.get("f1-score", 0)
                row[f"{b}_Test_Precision"] = m.get("precision", 0)
                row[f"{b}_Test_Recall"] = m.get("recall", 0)
            row[f"avg_test_f1_{target.replace(' ', '_')}"] = (
                test.get(target, {}).get("f1-score", 0)
            )
            rows.append(row)
        if not rows:
            return None
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = os.path.join(
            self.experiments_dir,
            f"final_evaluation_results_{self.dataset_name}_{ts}.csv",
        )
        pd.DataFrame(rows).to_csv(out, index=False)
        log_message(f"Final evaluation results saved to {out}")
        return out

    # -- phase 4: train_final -----------------------------------------------------

    def train_final_model(self) -> Optional[str]:
        fingerprint = self._fingerprint()
        provider = ManifestSplitProvider(self.outer_manifest_path, fingerprint)
        train_s, val_s, test_s = provider.get_split(0, [], [], [])
        pool = list(train_s) + list(val_s)
        log_message(f"Final training pool: {len(pool)} subjects (train+val).")

        params = dict(self.champion)
        params.update(num_runs=1, num_trials=1, use_test=False, test_split=0.0)
        task = self._make_task(params)

        class FinalFitSplitProvider(SplitProvider):
            def get_split(self, run_index, all_subjects, all_instances, behaviors,
                          allow_relaxed_fallback=False):
                return pool, [], []

        out_dir = os.path.join(
            self.experiments_dir,
            f"final_train_run_{datetime.now().strftime('%Y%m%d_%H%M%S')}",
        )
        model_dir = run_training_job(
            self.project, task, split_provider=FinalFitSplitProvider(),
            output_dir=out_dir, seed=self.seed, device=self.device,
        )
        # Experiment-scoped runs keep their bundle inside output_dir
        # (orchestrator._save_results); the deployable model is promoted to
        # the project's models dir as an explicit step (reference:
        # sweep_runner.py:476 "saved to the project's 'models' directory").
        # Re-saving through ClassifierBundle reuses its per-file tmp+rename
        # writes, which the ClassifyWorker hot-reload already tolerates.
        if model_dir and os.path.isdir(model_dir):
            from cbas_tpu_torch.engine.classifier import ClassifierBundle

            bundle = ClassifierBundle.load(model_dir)
            prod_dir = os.path.join(
                self.project.models_dir, f"{self.dataset_name}_model"
            )
            bundle.save(prod_dir, extra_meta=bundle.meta)
            log_message(f"Final model promoted to {prod_dir}.")
            model_dir = prod_dir
        self._update_card_from_evaluation(task, train_s, val_s, test_s)
        return model_dir

    def _update_card_from_evaluation(self, task, train_s, val_s, test_s) -> None:
        """Write the rigorous evaluate-phase metrics + pool counts to the
        dataset card (reference: sweep_runner.py:478-547)."""
        try:
            csvs = glob.glob(
                os.path.join(self.experiments_dir, "final_evaluation_results_*.csv")
            )
            if not csvs:
                raise FileNotFoundError(
                    "No final_evaluation_results CSV found; run the 'evaluate' phase first."
                )
            eval_df = pd.read_csv(max(csvs, key=os.path.getctime))

            instances = self._all_instances()
            train_set = set(train_s) | set(val_s)
            test_set = set(test_s)
            counts = {"train": {}, "test": {}}
            frames = {"train": {}, "test": {}}
            for inst in instances:
                group = (
                    "train" if subject_of(inst) in train_set
                    else "test" if subject_of(inst) in test_set
                    else None
                )
                if group:
                    label = inst["label"]
                    counts[group][label] = counts[group].get(label, 0) + 1
                    frames[group][label] = frames[group].get(label, 0) + (
                        int(inst["end"]) - int(inst["start"]) + 1
                    )

            config = load_yaml(self.dataset.config_path)
            config["metrics"] = {}
            for b in task.behaviors:
                block = {}
                for metric, col in (
                    ("F1 Score", f"{b}_Test_F1"),
                    ("Precision", f"{b}_Test_Precision"),
                    ("Recall", f"{b}_Test_Recall"),
                ):
                    if col in eval_df.columns:
                        block[metric] = round(float(eval_df[col].mean()), 2)
                block["Train Inst (Frames)"] = (
                    f"{counts['train'].get(b, 0)} ({int(frames['train'].get(b, 0))})"
                )
                block["Test Inst (Frames)"] = (
                    f"{counts['test'].get(b, 0)} ({int(frames['test'].get(b, 0))})"
                )
                config["metrics"][b] = block
            dump_yaml(config, self.dataset.config_path)
            self.dataset.config = config
            # run_training_job reloads the project, replacing its Dataset
            # objects; keep the live copy in sync with what we just wrote.
            live = self.project.datasets.get(self.dataset_name)
            if live is not None:
                live.config = config
            log_message("Updated dataset card from evaluation metrics.")
        except Exception as e:
            log_message(f"Could not update dataset card: {e}", "ERROR")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="CBAS-TPU headless sweep runner")
    parser.add_argument("--project_path", required=True)
    parser.add_argument("--dataset_name", required=True)
    parser.add_argument(
        "--phase", required=True,
        choices=["precompute", "sweep", "evaluate", "train_final"],
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument(
        "--jobs", type=int, default=1,
        help="sweep phase: fan combos out over this many single-chip "
             "worker processes (claim-guarded, resumable)",
    )
    parser.add_argument("--drain-only", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument(
        "--config", default=None,
        help="sweep_config.json written by a fan-out parent (or hand-written):"
             " parameter_grid/fixed/champion/n_*_splits overrides",
    )
    args = parser.parse_args(argv)

    # Tests/dev: CBAS_FORCE_CPU trains on the CPU instead of the CUDA device.
    device = "cpu" if os.environ.get("CBAS_FORCE_CPU") else "cuda"

    project = Project(args.project_path)
    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    runner = SweepRunner(project, args.dataset_name, seed=args.seed, device=device, **cfg)
    phase = {
        "precompute": runner.precompute_splits,
        "sweep": lambda: runner.run_sweep(jobs=args.jobs, drain_only=args.drain_only),
        "evaluate": runner.run_final_evaluation,
        "train_final": runner.train_final_model,
    }[args.phase]
    phase()


if __name__ == "__main__":
    main()
