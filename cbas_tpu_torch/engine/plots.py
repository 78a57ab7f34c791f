"""Training result plots (confusion matrices, epoch curves, cross-run bars).

Copy of ``cbas_tpu/engine/plots.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Same artifact set and filenames as the reference's plot suite
(backend/workthreads.py:1084-1168) so downstream tooling finds the PNGs.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from cbas_tpu_torch.engine.metrics import PerformanceReport


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, imported when a plot
    is drawn (the card's host has no matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_confusion_matrix_plot(
    cm: np.ndarray,
    path: str,
    labels: Sequence[str] | None = None,
    title: str = "Confusion Matrix",
    values_format: str = "d",
) -> None:
    if cm.size == 0:
        return
    from sklearn.metrics import ConfusionMatrixDisplay

    plt = _pyplot()
    disp = ConfusionMatrixDisplay(confusion_matrix=cm, display_labels=labels)
    fig, ax = plt.subplots(figsize=(8, 7))
    disp.plot(
        ax=ax, cmap="Blues", colorbar=False, xticks_rotation="vertical",
        values_format=values_format,
    )
    ax.set_title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def plot_epoch_metric(
    reports: List[PerformanceReport],
    metric: str,
    behaviors: Sequence[str],
    out_dir: str,
) -> None:
    """Per-behavior train/val curves of one metric over epochs."""
    if not reports:
        return
    plt = _pyplot()
    plt.figure(figsize=(10, 7))
    epochs = range(1, len(reports) + 1)
    colors = plt.get_cmap("tab10", len(behaviors))

    def series(getter):
        # 0.0 is a real score; only a missing metric becomes NaN.
        return [v if (v := getter(r)) is not None else np.nan for r in reports]

    for i, b in enumerate(behaviors):
        train = series(lambda r: r.train_report.get(b, {}).get(metric))
        val = series(lambda r: r.val_report.get(b, {}).get(metric))
        if not all(np.isnan(v) for v in train):
            plt.plot(epochs, train, marker="o", linestyle="-", label=f"{b} (Train)", color=colors(i))
        if not all(np.isnan(v) for v in val):
            plt.plot(epochs, val, marker="x", linestyle="--", label=f"{b} (Val)", color=colors(i))

    wt = series(lambda r: r.train_report.get("weighted avg", {}).get(metric))
    wv = series(lambda r: r.val_report.get("weighted avg", {}).get(metric))
    if not all(np.isnan(v) for v in wt):
        plt.plot(epochs, wt, marker="o", color="black", linewidth=2, label="Weighted Avg (Train)")
    if not all(np.isnan(v) for v in wv):
        plt.plot(epochs, wv, marker="x", linestyle="--", color="grey", linewidth=2, label="Weighted Avg (Val)")

    plt.xlabel("Epochs")
    plt.ylabel(metric.replace("-", " ").title())
    plt.title(f"{metric.replace('-', ' ').title()} Over Epochs")
    plt.legend(title="Behaviors", bbox_to_anchor=(1.04, 1), loc="upper left")
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout(rect=(0, 0, 0.8, 1))
    plt.savefig(os.path.join(out_dir, f"{metric.replace(' ', '_')}_epochs_plot.png"))
    plt.close()


def plot_run_metrics(
    reports: List[dict],
    behaviors: Sequence[str],
    out_dir: str,
    plot_suffix: str = "runs",
) -> None:
    """Cross-run mean+std bars with individual run scatter, per metric."""
    if not reports or not any(reports):
        return
    plt = _pyplot()
    rng = np.random.default_rng(0)
    for metric in ("precision", "recall", "f1-score"):
        plt.figure(figsize=(max(8, len(behaviors) * 0.6), 6))
        x = np.arange(len(behaviors))
        # NaN (not 0) for a behavior absent from a run's report — the relaxed
        # split fallback warns that rare behaviors may be missing from some
        # replicates' test sets, and injecting 0.0 for those runs would drag
        # the plotted mean down and inflate std for runs that never measured
        # the behavior at all. nanmean excludes them (matching the NaN
        # convention plot_epoch_metric already uses); scatter skips NaNs.
        values = [
            np.array([r.get(b, {}).get(metric, np.nan) for r in reports], float)
            for b in behaviors
        ]
        means = [float(np.nanmean(v)) if np.any(~np.isnan(v)) else 0.0 for v in values]
        stds = [float(np.nanstd(v)) if np.any(~np.isnan(v)) else 0.0 for v in values]
        plt.bar(
            x, means, yerr=stds, align="center", alpha=0.7, ecolor="black",
            capsize=10, label=f"Mean (n={len(reports)})",
        )
        for i, vals in enumerate(values):
            jitter = rng.normal(0, 0.04, size=len(vals))
            plt.scatter(
                i + jitter, vals, color="black", alpha=0.6, zorder=3,
                label="Individual Run" if i == 0 else "",
            )
        plt.ylabel(metric.replace("-", " ").title())
        plt.xticks(x, behaviors, rotation="vertical")
        plt.title(
            f"Average {metric.replace('-', ' ').title()} Across {len(reports)} "
            f"{plot_suffix.capitalize()}"
        )
        plt.grid(axis="y", linestyle="--", alpha=0.7)
        handles, labels = plt.gca().get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        plt.legend(uniq.values(), uniq.keys())
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, f"{metric.replace(' ', '_')}_{plot_suffix}_plot.png"))
        plt.close()
