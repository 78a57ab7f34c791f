"""Held-out split evaluation helper shared by the orchestrator and sweep.

Port of ``cbas_tpu/engine/evaluate_split.py``.
"""

from __future__ import annotations

from typing import List

from cbas_tpu_torch.engine.data import WindowSource
from cbas_tpu_torch.engine.train import evaluate_on_split
from cbas_tpu_torch.models.heads import DeltasHeadConfig


def evaluate_params_on_manifest(
    params: dict,
    task,
    manifest: List,
    batch_size: int = 512,
    device="cuda",
) -> dict:
    """Evaluate ``params`` on ``manifest``'s windows; ``task`` is a
    ``cbas_tpu.core.config.TrainingConfig``."""
    source = WindowSource(manifest, task.sequence_length)
    cfg = DeltasHeadConfig(
        in_features=source.embed_dim if manifest else 768,
        out_features=len(task.behaviors),
        seq_len=task.sequence_length,
        lstm_hidden_size=task.lstm_hidden_size,
        lstm_layers=task.lstm_layers,
    )
    return evaluate_on_split(
        params, cfg, source, task.behaviors, batch_size=batch_size, device=device
    )
