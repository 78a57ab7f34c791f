"""Circadian visualization: actograms, ethograms, binned exports.

Host-side rendering over the per-frame probability CSVs, matching the
reference's analysis semantics (backend/cbas.py:574-644,958-1007;
backend/visualize_page.py):

- activity: a frame is active for a behavior iff that behavior is the argmax
  AND its probability clears the threshold
- actogram: double-plotted days x 2*tau grid with LD/DD/LL light-cycle
  underlay, 90th-percentile vmax, optional per-day acrophase via the circular
  mean
- ethogram: contiguous behavior blocks as a bar raster ("background" last)
- binned export: per-behavior counts, NaN-padded, one CSV per subject
"""

from __future__ import annotations

import base64
import io
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from cbas_tpu_torch.utils.naming import natural_sort_outputs


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, imported when a
    figure is drawn: the binning and exports need no matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ---------------------------------------------------------------------------
# Activity extraction + binning
# ---------------------------------------------------------------------------

def activity_from_probs(
    df: pd.DataFrame, behavior: str, threshold: float
) -> np.ndarray:
    """Per-frame 0/1 activity: behavior is the strict maximum and
    prob >= threshold (reference: backend/cbas.py:977-978 uses the same
    strict ``others.max < probs`` — an exact probability tie counts as
    active for NO behavior, deliberately matched here)."""
    if behavior not in df.columns:
        return np.array([])
    probs = df[behavior].to_numpy()
    others = df[df.columns.drop(behavior)]
    is_max = (others.max(axis=1) < probs).to_numpy() if len(others.columns) else np.ones_like(probs, bool)
    # AND the argmax mask with the threshold test ((probs*is_max) >= thr
    # would mark every non-argmax frame active at threshold 0).
    return (is_max & (probs >= threshold)).astype(float)


def bin_activity(activity: np.ndarray, binsize_frames: int) -> np.ndarray:
    if binsize_frames <= 0 or activity.size == 0:
        return np.array([])
    return np.array(
        [
            activity[i : i + binsize_frames].sum()
            for i in range(0, len(activity), binsize_frames)
        ]
    )


def stitch_outputs(directory: str, model: str) -> Optional[pd.DataFrame]:
    """Concatenate all per-segment output CSVs for a model in recording order
    (reference: backend/visualize_page.py:119-136)."""
    # Suffix alone also matches models whose name merely ends with this one
    # ("big_mouse_model" vs "mouse_model"). A matching CSV is excluded ONLY
    # when there is positive evidence it belongs to a longer-named model: its
    # derived stem is not a known video stem but extends one ("cam_00001_big"
    # extends video "cam_00001" -> it is cam_00001's big_<model> output).
    # CSVs whose video/H5 were archived away keep stitching (no evidence).
    # Missing directory == no data (not an exception): the API layer treats
    # a None return as "nothing to plot", and the frontend shows a friendly
    # message instead of a stuck "generating…" spinner.
    if not os.path.isdir(directory):
        return None
    listing = os.listdir(directory)
    video_stems = {
        f[:-4] for f in listing if f.endswith(".mp4")
    } | {f[: -len("_cls.h5")] for f in listing if f.endswith("_cls.h5")}
    suffix = f"_{model}_outputs.csv"
    csvs = []
    for f in listing:
        if not f.endswith(suffix):
            continue
        stem = f[: -len(suffix)]
        if stem.endswith("_aug"):
            # Augmented siblings (*_aug.mp4, training-only artifacts) get
            # classified alongside the real segments; stitching them would
            # double-count every time bin and, because aug names miss the
            # _<segment>_ regex, lexicographic fallback would interleave
            # them — scrambling the actogram timeline. The UI hides aug
            # videos the same way (api.py is_aug_video).
            continue
        if stem not in video_stems and any(
            stem.startswith(vs + "_") for vs in video_stems
        ):
            continue  # another (longer-named) model's output for a known video
        csvs.append(os.path.join(directory, f))
    if not csvs:
        return None
    frames = [pd.read_csv(p) for p in natural_sort_outputs(csvs, model)]
    frames = [f for f in frames if not f.empty]
    if not frames:
        return None
    return pd.concat(frames, ignore_index=True)


# ---------------------------------------------------------------------------
# Actogram
# ---------------------------------------------------------------------------

def _light_pattern(light_cycle: Sequence[bool], bins_per_period: int):
    """Per-bin light/dark underlay, exactly ``bins_per_period`` wide.

    The pattern is built by sampling the 24-entry cycle at each bin's
    position in the period, so it stays aligned for ANY bin size — the
    reference's ``np.repeat(cycle, 60 // bsm)`` (cbas.py:605) collapses to an
    empty underlay for bins over 60 min and drifts for bin sizes that don't
    divide 60 (24 pattern columns stretched over e.g. 32 bins). Documented
    deviation: docs/Compatibility.md.
    """
    from matplotlib.colors import LinearSegmentedColormap

    light_yellow, dark_yellow = "#FEFDE3", "#E8D570"
    light_grey, dark_grey = "#D3D3D3", "#A9A9A9"
    n = max(1, int(bins_per_period))
    if all(light_cycle):  # LL: 12 h light / 12 h "shadow" gradient halves
        half = (n + 1) // 2
        pattern = [1] * half + [0] * (n - half)
        cmap = LinearSegmentedColormap.from_list("light_cmap", [dark_yellow, light_yellow])
    elif not any(light_cycle):  # DD
        half = (n + 1) // 2
        pattern = [1] * half + [0] * (n - half)
        cmap = LinearSegmentedColormap.from_list("light_cmap", [dark_grey, light_grey])
    else:  # LD: sample the 24 h cycle at each bin's fraction of the period
        cyc = [int(b) for b in light_cycle]
        pattern = [cyc[int(i * len(cyc) / n) % len(cyc)] for i in range(n)]
        cmap = LinearSegmentedColormap.from_list("light_cmap", [dark_grey, light_yellow])
    return np.asarray(pattern), cmap


def render_actogram_figure(
    binned_activity: np.ndarray,
    light_cycle: Sequence[bool],
    tau: float,
    bin_size_minutes: int,
    title: str,
    start_hour_offset: float,
    plot_acrophase: bool = False,
    base_color: Optional[str] = None,
):
    """Double-plotted actogram figure (reference: backend/cbas.py:574-644)."""
    plt = _pyplot()
    from matplotlib.colors import LinearSegmentedColormap

    bins_per_period = int(tau * 60 / bin_size_minutes)
    if bins_per_period == 0:
        return None
    padding_bins = int(start_hour_offset * 60 / bin_size_minutes)
    padded = np.pad(np.asarray(binned_activity, float), (padding_bins, 0))
    num_days = math.ceil(len(padded) / bins_per_period)
    if num_days < 1:
        return None
    required = num_days * bins_per_period
    padded = np.pad(padded, (0, required - len(padded)), constant_values=np.nan)
    daily = padded.reshape(num_days, bins_per_period)

    acrophase_points = []
    if plot_acrophase:
        t = np.linspace(0, 2 * np.pi, bins_per_period, endpoint=False)
        for day, day_act in enumerate(daily):
            if np.isnan(day_act).any() or np.nansum(day_act) == 0:
                continue
            act = np.nan_to_num(day_act)
            phase = math.atan2((act * np.sin(t)).sum(), (act * np.cos(t)).sum())
            # The daily grid is ALREADY time-of-day aligned (front-padded by
            # start_hour_offset above), so the circular mean is an absolute
            # hour — the reference adds start_hour_offset a second time here
            # (cbas.py:592), plotting every marker that many hours late; it
            # also hardcodes 24 where the plot axis spans tau. Documented
            # deviation: docs/Compatibility.md.
            hour = ((phase / (2 * np.pi)) * tau + tau) % tau
            acrophase_points.append((day, hour))

    right = np.full_like(daily, np.nan)
    if num_days > 1:
        right[:-1] = daily[1:]
    double_plotted = np.concatenate([daily, right], axis=1)

    pattern, light_cmap = _light_pattern(light_cycle, bins_per_period)
    double_light = np.array([np.concatenate([pattern, pattern]) for _ in range(num_days)])

    if base_color:
        act_cmap = LinearSegmentedColormap.from_list("mono", [(0, 0, 0, 0), base_color])
    else:
        viridis = plt.get_cmap("viridis")
        colors = viridis(np.arange(viridis.N))
        colors[0, 3] = 0
        act_cmap = LinearSegmentedColormap.from_list("transparent_viridis", colors)
    act_cmap.set_bad(color=(0, 0, 0, 0))

    fig, ax = plt.subplots(figsize=(10, max(4, num_days * 0.4)), dpi=120)
    fig.patch.set_facecolor("#343a40")
    ax.set_facecolor("#343a40")
    extent = (0.0, 2 * tau, float(num_days), 0.0)
    ax.imshow(double_light, aspect="auto", cmap=light_cmap, interpolation="none",
              extent=extent, vmin=0, vmax=1)
    nonzero = [v for v in binned_activity if v > 0]
    vmax = np.percentile(nonzero, 90) + 1e-6 if nonzero else 1
    cax = ax.imshow(double_plotted, aspect="auto", cmap=act_cmap, interpolation="none",
                    extent=extent, vmin=0, vmax=vmax)
    for day, hour in acrophase_points:
        ax.plot(hour, day + 0.5, "o", color="red", markersize=8, markeredgecolor="black")
        ax.plot(hour + tau, day + 0.5, "o", color="red", markersize=8, markeredgecolor="black")

    cbar = fig.colorbar(cax, ax=ax, orientation="vertical", pad=0.02)
    cbar.set_label("Event Count", color="white")
    cbar.ax.yaxis.set_tick_params(color="white")
    cbar.outline.set_edgecolor("white")
    plt.setp(plt.getp(cbar.ax.axes, "yticklabels"), color="white")
    ax.set_title(title, color="white", pad=20)
    ax.set_xlabel("Time of Day (Double Plotted)", color="white")
    ax.set_ylabel("Day", color="white")
    ax.tick_params(colors="white")
    for spine in ax.spines.values():
        spine.set_edgecolor("white")
    ax.set_xlim(0, 2 * tau)
    ax.set_ylim(num_days, 0)
    ax.set_xticks(np.arange(0, 2 * tau + 1, 4))
    ax.set_xticklabels([f"{int(t % 24):02d}" for t in np.arange(0, 2 * tau + 1, 4)])
    ax.set_yticks(np.arange(0.5, num_days, 1))
    ax.set_yticklabels([f"{i + 1}" for i in range(num_days)])
    fig.tight_layout()
    return fig


LIGHT_CYCLES = {"LL": "1" * 24, "DD": "0" * 24}


class Actogram:
    """Actogram over one subject's stitched predictions (reference API)."""

    def __init__(
        self,
        behavior: str,
        framerate: float,
        start: float,
        binsize_minutes: int,
        threshold: float,
        lightcycle: str = "LD",
        plot_acrophase: bool = False,
        base_color: Optional[str] = None,
        directory: Optional[str] = None,
        model: Optional[str] = None,
        preloaded_df: Optional[pd.DataFrame] = None,
        tau: float = 24.0,
    ):
        self.behavior = behavior
        self.framerate = float(framerate)
        self.start_hour = float(start)
        self.bin_size_minutes = int(binsize_minutes)
        self.threshold = float(threshold)
        self.lightcycle_str = LIGHT_CYCLES.get(lightcycle, "1" * 12 + "0" * 12)
        self.blob: Optional[str] = None
        self.binned_activity: List[float] = []

        if self.framerate <= 0 or self.bin_size_minutes <= 0:
            return
        binsize_frames = int(self.bin_size_minutes * self.framerate * 60)
        if binsize_frames <= 0:
            return

        if preloaded_df is not None:
            df = preloaded_df
        elif directory and model:
            df = stitch_outputs(directory, model)
        else:
            return
        if df is None or df.empty or behavior not in df.columns:
            return

        activity = activity_from_probs(df, behavior, self.threshold)
        self.binned_activity = bin_activity(activity, binsize_frames).tolist()
        if not self.binned_activity:
            return
        fig = render_actogram_figure(
            np.asarray(self.binned_activity),
            [c == "1" for c in self.lightcycle_str],
            tau,
            self.bin_size_minutes,
            f"{model} - {behavior}" if model else behavior,
            self.start_hour,
            plot_acrophase,
            base_color,
        )
        if fig is not None:
            buf = io.BytesIO()
            fig.savefig(buf, format="png", bbox_inches="tight", facecolor="#343a40")
            buf.seek(0)
            self.blob = base64.b64encode(buf.read()).decode("utf-8")
            _pyplot().close(fig)


# ---------------------------------------------------------------------------
# Binned CSV export
# ---------------------------------------------------------------------------

def export_binned_csv(
    df: pd.DataFrame,
    behaviors: Sequence[str],
    framerate: float,
    bin_size_minutes: int,
    threshold: float,
    out_path: str,
) -> Optional[str]:
    """Per-behavior binned activity counts, NaN-padded to equal length
    (reference: backend/visualize_page.py:203-270)."""
    binsize_frames = int(bin_size_minutes * framerate * 60)
    if binsize_frames <= 0:
        return None
    series = {}
    for b in behaviors:
        act = activity_from_probs(df, b, threshold)
        if act.size:
            series[b] = bin_activity(act, binsize_frames)
    if not series:
        return None
    n = max(len(v) for v in series.values())
    table = {
        b: np.pad(v.astype(float), (0, n - len(v)), constant_values=np.nan)
        for b, v in series.items()
    }
    out = pd.DataFrame(table)
    out.insert(0, "bin_index", np.arange(n))
    out.to_csv(out_path, index=False)
    return out_path


def binned_export_filename(subject: str, model: str) -> str:
    ts = time.strftime("%Y%m%d_%H%M%S")
    return f"BinnedData_{subject}_{model}_{ts}.csv"


# ---------------------------------------------------------------------------
# Ethogram
# ---------------------------------------------------------------------------

def ethogram_events(
    df: pd.DataFrame, behaviors: Sequence[str]
) -> Dict[str, List[tuple]]:
    """Contiguous argmax blocks per behavior as (start, length) pairs
    (reference: backend/visualize_page.py:277-438)."""
    if df is None or df.empty:
        return {}
    probs = df[list(behaviors)].to_numpy()
    pred = probs.argmax(axis=1)
    events: Dict[str, List[tuple]] = {b: [] for b in behaviors}
    start = 0
    for i in range(1, len(pred) + 1):
        if i == len(pred) or pred[i] != pred[start]:
            events[behaviors[pred[start]]].append((start, i - start))
            start = i
    return events


def render_ethogram_figure(
    df: pd.DataFrame,
    behaviors: Sequence[str],
    framerate: float,
    title: str = "Ethogram",
):
    """Horizontal bar raster; 'background' plotted last if present."""
    order = [b for b in behaviors if b != "background"]
    if "background" in behaviors:
        order.append("background")
    events = ethogram_events(df, behaviors)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, max(3, 0.5 * len(order))), dpi=120)
    fig.patch.set_facecolor("#343a40")
    ax.set_facecolor("#343a40")
    cmap = plt.get_cmap("tab10", len(order))
    scale = 1.0 / (framerate * 60.0) if framerate > 0 else 1.0  # frames -> minutes
    for row, b in enumerate(order):
        spans = [(s * scale, l * scale) for s, l in events.get(b, [])]
        if spans:
            ax.broken_barh(spans, (row - 0.4, 0.8), facecolors=cmap(row))
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels(order, color="white")
    ax.set_xlabel("Time (minutes)", color="white")
    ax.set_title(title, color="white")
    ax.tick_params(colors="white")
    for spine in ax.spines.values():
        spine.set_edgecolor("white")
    fig.tight_layout()
    return fig


def ethogram_blob(df: pd.DataFrame, behaviors: Sequence[str], framerate: float, title: str = "Ethogram") -> Optional[str]:
    fig = render_ethogram_figure(df, behaviors, framerate, title)
    if fig is None:
        return None
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", facecolor="#343a40")
    buf.seek(0)
    blob = base64.b64encode(buf.read()).decode("utf-8")
    _pyplot().close(fig)
    return blob
