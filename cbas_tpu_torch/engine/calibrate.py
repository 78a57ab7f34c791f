"""Temperature calibration of model confidence.

Port of ``cbas_tpu/engine/calibrate.py``: minimise validation NLL over a
softplus-parameterised scalar temperature clamped to (1e-3, 10]. The logits
are collected once by the head on the device; the 1-D fit runs on the host
with scipy. ``fit_temperature_from_logits`` is a copy of the JAX package's
(whose module imports jax), held equal to it by a test.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.optimize import minimize

from cbas_tpu_torch.engine.data import SequentialSampler, WindowSource
from cbas_tpu_torch.engine.train import build_logits_program, collect_logits_source
from cbas_tpu_torch.models.convert import deltas_params_from_numpy
from cbas_tpu_torch.models.heads import DeltasHeadConfig


def _clamp_temp(t_raw: float) -> float:
    # softplus(t) + 1e-3, clamped to <= 10
    return float(min(np.logaddexp(0.0, t_raw) + 1e-3, 10.0))


def fit_temperature_from_logits(logits: np.ndarray, labels: np.ndarray) -> float:
    """Optimal clamped-softplus temperature for NLL on (logits, labels)."""
    if logits.size == 0:
        return 1.0
    logits = logits.astype(np.float64)
    labels = labels.astype(np.int64)

    def nll(t_raw: np.ndarray) -> float:
        temp = min(np.logaddexp(0.0, t_raw[0]) + 1e-3, 10.0)
        z = logits / temp
        z = z - z.max(axis=1, keepdims=True)
        logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
        return float(-logp[np.arange(len(labels)), labels].mean())

    res = minimize(nll, x0=np.array([1.0]), method="Nelder-Mead", options={"xatol": 1e-6})
    return _clamp_temp(float(res.x[0]))


def fit_temperature(
    params: dict,
    cfg: DeltasHeadConfig,
    val_source: Optional[WindowSource],
    batch_size: int = 512,
    device="cuda",
) -> float:
    """Collect validation logits with the head on ``device`` and fit the
    temperature."""
    if val_source is None or len(val_source) == 0:
        return 1.0
    logits_prog = build_logits_program(deltas_params_from_numpy(params, cfg, device))
    logits, labels = collect_logits_source(
        logits_prog, val_source, SequentialSampler(len(val_source)), batch_size,
    )
    if logits.size == 0:
        return 1.0
    return fit_temperature_from_logits(logits, labels)
