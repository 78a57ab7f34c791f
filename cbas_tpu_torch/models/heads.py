"""The deltas behaviour-classification head in PyTorch.

Port of ``cbas_tpu/models/heads.py``'s ``ClassifierLSTMDeltas`` rebuild:
EMA-smoothed CLS stream + velocity + acceleration bottlenecks, biLSTM over
the fused stream, temperature-softmax attention pooling over the centre
window, a parallel linear branch on the smoothed CLS centre window, and a
learnable sigmoid gate fusing the two.

:class:`DeltasHead` is an ``nn.Module`` whose ``state_dict`` names are the
JAX package's parameter names (the reference torch head's), so a bundle's
numpy params load with a strict ``load_state_dict``. Dropout fires only
when the module is in training mode and a ``torch.Generator`` is passed (the
JAX rule: ``train`` set and an rng given), so train mode without a generator
computes the eval forward.

:class:`LegacyHead` is the v2 ``ClassifierLegacyLSTM``, kept for running old
bundles: inference only, BatchNorm on its running statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cbas_tpu_torch.models.lstm import init_lstm_params, lstm_forward, make_lstm
from cbas_tpu_torch.ops.ema import robust_deltas

LSTM_IN = 256  # width of lin0, the LSTM's input
BOTTLENECK_DROPOUT = 0.1  # after each bottleneck's GELU, before its LayerNorm


@dataclass(frozen=True)
class DeltasHeadConfig:
    """Hyperparameters of the deltas head (as ``cbas_tpu.models.heads``)."""

    in_features: int = 768
    out_features: int = 2
    seq_len: int = 31
    bottleneck_dim: int = 128
    dropout_p: float = 0.15
    use_acceleration: bool = True
    ema_alpha: float = 0.3
    center_window_size: int = 5
    lstm_hidden_size: int = 64
    lstm_layers: int = 1

    @property
    def hsl(self) -> int:
        return self.seq_len // 2


def _center_bounds(hsl: int, sw: int, length: int) -> Tuple[int, int]:
    return max(0, hsl - sw), min(length, hsl + sw + 1)


def _dropout(
    x: torch.Tensor, p: float, train: bool, generator: Optional[torch.Generator],
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (never the
    global RNG); identity unless ``train`` and a generator are both given.
    ``keep``, a mask drawn beforehand (:func:`dropout_masks`), is used
    instead of a draw."""
    if keep is not None:
        return torch.where(keep, x / (1.0 - p), 0.0)
    if not train or p <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def dropout_masks(
    cfg: "DeltasHeadConfig", batch: int, length: int, generator: torch.Generator, device
) -> List[Optional[torch.Tensor]]:
    """The keep masks :func:`deltas_forward` draws in training for a batch of
    ``batch`` windows of ``length`` frames, drawn from ``generator`` in its
    order and shapes (each stream's bottleneck, then lin0; None where the
    rate is 0): the same numbers it would draw. A data-parallel step draws
    them once for the global batch and gives each shard its rows."""
    sites = [((batch, length, cfg.bottleneck_dim), BOTTLENECK_DROPOUT) for _ in _streams(cfg)]
    sites.append(((batch, length, LSTM_IN), cfg.dropout_p))
    return [torch.rand(shape, generator=generator, device=device) >= p if p > 0.0 else None
            for shape, p in sites]


def _streams(cfg: DeltasHeadConfig):
    return ("cls", "delta", "acc") if cfg.use_acceleration else ("cls", "delta")


class DeltasHead(nn.Module):
    def __init__(self, cfg: DeltasHeadConfig):
        super().__init__()
        self.cfg = cfg
        for s in _streams(cfg):
            setattr(self, f"{s}_bottleneck",
                    nn.Sequential(nn.Linear(cfg.in_features, cfg.bottleneck_dim)))
            setattr(self, f"{s}_ln", nn.LayerNorm(cfg.bottleneck_dim))
        self.lin0 = nn.Sequential(nn.Linear(cfg.bottleneck_dim * len(_streams(cfg)), LSTM_IN))
        self.gate = nn.Parameter(torch.tensor(0.2))
        self.lstm = make_lstm(LSTM_IN, cfg.lstm_hidden_size, cfg.lstm_layers)
        self.attention_head = nn.Linear(cfg.lstm_hidden_size * 2, 1)
        self.attention_temp = nn.Parameter(torch.tensor(1.0))
        self.lin1 = nn.Linear(cfg.in_features, cfg.out_features)
        self.lin2 = nn.Linear(cfg.lstm_hidden_size * 2, cfg.out_features)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return deltas_forward(self, x, generator)


def deltas_forward(
    head: DeltasHead, x: torch.Tensor, generator: Optional[torch.Generator] = None,
    masks: Optional[List[Optional[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, in_features) -> (logits (B, out), latent (B, 2H)).

    Dropout masks are drawn from ``generator`` in the JAX order (cls, delta,
    acc bottlenecks, then lin0) when ``head.training``; ``masks``
    (:func:`dropout_masks`' list, or rows of it) are used instead of draws.
    """
    return deltas_pool(head, *deltas_features(head, x, generator, masks))


def deltas_features(
    head: DeltasHead, x: torch.Tensor, generator: Optional[torch.Generator] = None,
    masks: Optional[List[Optional[torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-window part of :func:`deltas_forward` (the linear branch,
    the bottlenecks and the LSTM): (B, T, in_features) -> (linear logits
    (B, out), LSTM output (B, T, 2H))."""
    cfg = head.cfg
    train = head.training
    pending = iter(masks) if masks is not None else None

    def dropout(t, p):
        if pending is None:
            return _dropout(t, p, train, generator)
        return _dropout(t, p, train, None, keep=next(pending))

    T = x.shape[1]
    smooth, delta, acc = robust_deltas(x, cfg.ema_alpha)

    # Linear branch: mean of per-frame logits over the smoothed centre window.
    l, r = _center_bounds(cfg.hsl, cfg.center_window_size, T)
    if l >= r:
        idx = min(max(0, T // 2), T - 1) if T > 0 else 0
        linear_logits = head.lin1(smooth[:, idx, :])
    else:
        linear_logits = head.lin1(smooth[:, l:r, :]).mean(dim=1)

    streams = {"cls": smooth, "delta": delta, "acc": acc}
    x_aug = torch.cat(
        [
            getattr(head, f"{s}_ln")(dropout(
                F.gelu(getattr(head, f"{s}_bottleneck")(streams[s])), BOTTLENECK_DROPOUT,
            ))
            for s in _streams(cfg)
        ],
        dim=-1,
    )
    x_lstm = dropout(F.gelu(head.lin0(x_aug)), cfg.dropout_p)
    # Mean-centre over time in fp32.
    x_lstm = (x_lstm - x_lstm.float().mean(dim=1, keepdim=True)).to(x_lstm.dtype)

    return linear_logits, lstm_forward(head.lstm, x_lstm)


def deltas_pool(
    head: DeltasHead, linear_logits: torch.Tensor, lstm_out: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head's last part, over :func:`deltas_features`' outputs: the
    attention pooling of the LSTM's centre window and the gated sum of the
    two branches -> (logits, latent). A data-parallel step runs it on the
    whole gathered batch, so the pooling's parameters get their gradients
    summed in the single-device order (the attention bias's true gradient is
    0 and its rounding noise, which Adam scales up, must match too)."""
    cfg = head.cfg
    L = lstm_out.shape[1]
    l, r = _center_bounds(cfg.hsl, cfg.center_window_size, L)
    if l >= r:
        idx = min(max(0, L // 2), L - 1) if L > 0 else 0
        attended = lstm_out[:, idx, :]
    else:
        center = lstm_out[:, l:r, :]
        temp = F.softplus(head.attention_temp) + 1e-3
        scores = head.attention_head(center)[..., 0] / temp
        weights = torch.softmax(scores, dim=1)[..., None]
        attended = (weights * center).sum(dim=1)

    lstm_logits = head.lin2(attended)
    gate = torch.sigmoid(head.gate)
    return linear_logits + gate * (lstm_logits - linear_logits), attended


@dataclass(frozen=True)
class LegacyHeadConfig:
    """Hyperparameters of the v2 head (as ``cbas_tpu.models.heads``), plus
    ``lstm_input``, lin0's width, which a bundle's weights give."""

    in_features: int = 768
    out_features: int = 2
    seq_len: int = 31
    lstm_hidden_size: int = 64  # fixed at 64 in the reference
    center_window_size: int = 5
    lstm_input: int = LSTM_IN

    @property
    def hsl(self) -> int:
        return self.seq_len // 2


class LegacyHead(nn.Module):
    """The v2 ``ClassifierLegacyLSTM``: BatchNorm over features, a linear
    branch on the centre window, lin0 -> mean-centre -> biLSTM -> centre
    mean -> lin2."""

    def __init__(self, cfg: LegacyHeadConfig):
        super().__init__()
        self.cfg = cfg
        self.batch_norm = nn.BatchNorm1d(cfg.in_features)
        self.lin0 = nn.Linear(cfg.in_features, cfg.lstm_input)
        self.lstm = make_lstm(cfg.lstm_input, cfg.lstm_hidden_size, 1)
        self.lin1 = nn.Linear(cfg.in_features, cfg.out_features)
        self.lin2 = nn.Linear(cfg.lstm_hidden_size * 2, cfg.out_features)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return legacy_forward(self, x)


def legacy_forward(
    head: LegacyHead, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lstm_logits, linear_logits, latent); the inference output is their
    sum (:func:`legacy_forward_nodrop`).

    Inference only, as in the JAX package: train-mode BatchNorm (batch
    statistics, running-stat updates) is not implemented, so a module in
    training mode raises.
    """
    if head.training:
        raise NotImplementedError(
            "legacy_forward is inference-only: train-mode BatchNorm is not "
            "implemented for the v2 legacy head (train the deltas head instead)."
        )
    cfg = head.cfg
    bn = head.batch_norm
    xn = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps) * bn.weight + bn.bias
    l, r = _center_bounds(cfg.hsl, cfg.center_window_size, xn.shape[1])
    linear_logits = head.lin1(xn[:, l:r, :]).mean(dim=1)
    x_lstm = head.lin0(xn)
    x_lstm = x_lstm - x_lstm.mean(dim=1, keepdim=True)
    lstm_out = lstm_forward(head.lstm, x_lstm)
    latent = lstm_out[:, l:r, :].mean(dim=1)
    return head.lin2(latent), linear_logits, latent


def legacy_forward_nodrop(head: LegacyHead, x: torch.Tensor) -> torch.Tensor:
    lstm_logits, linear_logits, _ = legacy_forward(head, x)
    return lstm_logits + linear_logits


def init_deltas_params(seed: int, cfg: DeltasHeadConfig) -> Dict[str, np.ndarray]:
    """torch-equivalent random init from ``numpy.random.default_rng(seed)``:
    U(+-1/sqrt(fan_in)) linears, unit LayerNorms, gate 0.2, temperature 1."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}

    def linear(name: str, fan_in: int, fan_out: int) -> None:
        bound = 1.0 / np.sqrt(fan_in)
        params[f"{name}.weight"] = rng.uniform(-bound, bound, (fan_out, fan_in)).astype(np.float32)
        params[f"{name}.bias"] = rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)

    for s in _streams(cfg):
        linear(f"{s}_bottleneck.0", cfg.in_features, cfg.bottleneck_dim)
        params[f"{s}_ln.weight"] = np.ones((cfg.bottleneck_dim,), np.float32)
        params[f"{s}_ln.bias"] = np.zeros((cfg.bottleneck_dim,), np.float32)
    linear("lin0.0", cfg.bottleneck_dim * len(_streams(cfg)), LSTM_IN)
    params["gate"] = np.asarray(0.2, np.float32)
    linear("attention_head", cfg.lstm_hidden_size * 2, 1)
    params["attention_temp"] = np.asarray(1.0, np.float32)
    linear("lin1", cfg.in_features, cfg.out_features)
    linear("lin2", cfg.lstm_hidden_size * 2, cfg.out_features)
    params.update(init_lstm_params(rng, LSTM_IN, cfg.lstm_hidden_size, cfg.lstm_layers))
    return params


def infer_deltas_hparams(params: Mapping[str, np.ndarray]) -> Dict[str, int]:
    """Recover lstm_hidden_size / lstm_layers from weight shapes."""
    if "attention_head.weight" in params:
        hidden = int(params["attention_head.weight"].shape[1]) // 2
    else:
        hidden = int(params["lin2.weight"].shape[1]) // 2
    layer_ids = [
        int(k.split("weight_ih_l")[1].split("_")[0])
        for k in params
        if "lstm.weight_ih_l" in k
    ]
    layers = max(layer_ids) + 1 if layer_ids else 1
    return {"lstm_hidden_size": hidden or 64, "lstm_layers": layers}
