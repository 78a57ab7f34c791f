"""Head training in PyTorch with the JAX package's loss recipe and loop.

Port of ``cbas_tpu/engine/train.py``, name for name:

- ``torch.optim.Adam`` with coupled L2 in two groups: 1e-3 on the fusion
  ``gate``, ``weight_decay`` on the rest (optax ``add_decayed_weights``
  before ``scale_by_adam``: the decay joins the gradient before the moments);
- cross-entropy with optional class weights and label smoothing in
  ``torch.nn.CrossEntropyLoss``'s weighted-mean semantics, and the
  covariance-decorrelation loss on the attended latent; rows labelled -1
  are masked out of every reduction;
- a class-balanced oversampled train stream, per-epoch train and validation
  reports, early stopping on the validation F1 of ``optimization_target``,
  cancellation and resumable checkpoints.

The head is an ``nn.Module`` that holds the parameters, so the compiled
programs of the JAX package become closures over the module: a train step
``step(x, y, generator)`` (or ``step(features, centers, y, generator)`` on
the device-gather path) updates the head in place and returns the loss as a
device tensor, without a host sync. Batches have one fixed shape; padded
rows carry label -1. Dropout draws from an explicit ``torch.Generator``.

With a mesh (``parallel/mesh.py``) the programs are data-parallel over its
data axis and compute what the single-device programs compute on the same
global batch (up to the order of sums): the head lives on the mesh's first
device and has a copy on each other data device, refreshed from it at every
call; each shard runs the per-window layers (``deltas_features``) on its
rows of the batch in its own thread with its rows of the dropout masks
(drawn once for the global batch, in the single-device order); their
outputs are gathered on the first device, where the pooling
(``deltas_pool``) and the loss (the covariance term is over the global
batch) run and autograd flows back across the copies; the copies' gradients
are summed into the head's and Adam steps there. ``train_head`` rounds the batch size up to
the data axis and replicates ``DeviceWindowStore`` on each data device.
"""

from __future__ import annotations

import copy
import json
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cbas_tpu_torch.utils.metrics import TRAIN_STEPS, metrics
from cbas_tpu_torch.engine.data import (
    DATASET_NAME,
    BalancedSampler,
    DeviceWindowStore,
    SequentialSampler,
    WindowSource,
    iter_batches,
)
from cbas_tpu_torch.engine.metrics import PerformanceReport, f1_of, report_and_cm
from cbas_tpu_torch.models.convert import deltas_params_from_numpy
from cbas_tpu_torch.models.heads import (
    DeltasHead,
    DeltasHeadConfig,
    deltas_features,
    deltas_forward,
    deltas_pool,
    dropout_masks,
    init_deltas_params,
)

Params = Dict[str, np.ndarray]


# ---------------------------------------------------------------------------
# Loss pieces
# ---------------------------------------------------------------------------

def masked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor],
    label_smoothing: float,
) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss(weight, label_smoothing) with -1 masking.

    Per-sample NLL weighted by the target's class weight; the smoothing term
    sums class-weighted log-probs / C; the mean divides by the sum of target
    weights.
    """
    C = logits.shape[-1]
    valid = labels >= 0
    safe_labels = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)

    w = (class_weights if class_weights is not None
         else torch.ones(C, dtype=logits.dtype, device=logits.device))
    nll = -logp.gather(1, safe_labels[:, None])[:, 0]
    smooth = -(logp * w[None, :]).sum(-1) / C
    wi = w[safe_labels] * valid
    per = (1.0 - label_smoothing) * nll * wi + label_smoothing * smooth * valid
    return per.sum() / wi.sum().clamp_min(1e-9)


def covariance_loss(latent: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum of squared off-diagonals of the valid-row batch covariance; 0 for
    fewer than two valid rows, chosen on the device (no host sync)."""
    n = valid.sum()
    mask = valid[:, None].to(latent.dtype)
    mean = (latent * mask).sum(0) / n.clamp_min(1)
    centered = (latent - mean) * mask
    cov = centered.T @ centered / (n - 1).clamp_min(1)
    off = (cov**2).sum() - (torch.diagonal(cov) ** 2).sum()
    return torch.where(n > 1, off, torch.zeros_like(off))


# ---------------------------------------------------------------------------
# Optimizer (torch.optim.Adam with per-group coupled L2)
# ---------------------------------------------------------------------------

def make_optimizer(
    head: DeltasHead, lr: float, weight_decay: float, gate_decay: float = 1e-3
) -> torch.optim.Adam:
    """Adam over ``head``'s parameters: ``gate`` decays by ``gate_decay``,
    everything else by ``weight_decay``. Build it after the head is on its
    device (the optimizer keeps its moments where the parameters live)."""
    named = list(head.named_parameters())
    return torch.optim.Adam(
        [
            {"params": [p for n, p in named if n != "gate"], "weight_decay": weight_decay},
            {"params": [p for n, p in named if n == "gate"], "weight_decay": gate_decay},
        ],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
    )


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

def _device_of(head: DeltasHead) -> torch.device:
    return next(head.parameters()).device


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _gather_windows(features: torch.Tensor, centers: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(R, D) device buffer + (B,) centre rows -> (B, seq_len, D) fp32 windows."""
    half = seq_len // 2
    offsets = torch.arange(-half, half + 1, device=features.device)
    return features[centers[:, None] + offsets[None, :]].float()


class _Replicas:
    """``head`` (on the mesh's first device) and a copy of it on each other
    device of the mesh's data axis: ``module(s)`` is data shard s's. Shards
    on the head's device use the head itself, so their gradients land in
    its ``.grad`` directly."""

    def __init__(self, head: DeltasHead, mesh):
        from cbas_tpu_torch.parallel.mesh import check_devices

        check_devices(mesh)
        self.head = head
        self.devices = list(mesh.grid()[:, 0])
        primary = _device_of(head)
        if self.devices[0] != primary:
            raise ValueError(f"the head is on {primary}, the mesh starts at {self.devices[0]}")
        self._by_device = {primary: head}
        for d in self.devices:
            if d not in self._by_device:
                self._by_device[d] = copy.deepcopy(head).to(d)
                if d.type == "cuda":
                    self._by_device[d].lstm.flatten_parameters()
        self._copies = [m for m in self._by_device.values() if m is not head]

    def module(self, shard: int) -> DeltasHead:
        return self._by_device[self.devices[shard]]

    def refresh(self, train: bool) -> None:
        """The head's weights into every copy, and every module in train or
        eval mode."""
        with torch.no_grad():
            for c in self._copies:
                for cp, p in zip(c.parameters(), self.head.parameters()):
                    cp.copy_(p)
        for m in self._by_device.values():
            m.train(train)

    def gather_grads(self) -> None:
        """The copies' gradients added into the head's (then cleared)."""
        for c in self._copies:
            for cp, p in zip(c.parameters(), self.head.parameters()):
                if cp.grad is not None:
                    g = cp.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad + g
                    cp.grad = None

    def run(self, fn, n_rows: int) -> list:
        """``fn(shard, rows, device)`` on each data shard in its thread,
        ``rows`` the shard's slice of ``range(n_rows)``; the results in order."""
        from cbas_tpu_torch.parallel.mesh import run_shards

        n = len(self.devices)
        if n_rows % n:
            raise ValueError(f"a batch of {n_rows} does not split over {n} data shards")
        per = n_rows // n
        return run_shards([lambda s=s: fn(s, slice(s * per, (s + 1) * per), self.devices[s])
                           for s in range(n)], self.devices)


def _on(features, device: torch.device) -> torch.Tensor:
    """A data device's copy of the window store's rows (a dict from a
    replicated ``DeviceWindowStore``), or ``features`` copied there."""
    return features[device] if isinstance(features, dict) else features.to(device)


def build_train_step(
    head: DeltasHead,
    optimizer: torch.optim.Optimizer,
    class_weights: Optional[np.ndarray],
    label_smoothing: float,
    gather_seq_len: Optional[int] = None,
    mesh=None,
):
    """The train step over ``head`` and ``optimizer``.

    Two data paths: host windows (``step(x, y, generator)`` with x the
    (B, T, D) float32 array) or the device-resident gather (``gather_seq_len``
    set: ``step(features, centers, y, generator)`` slices the windows from
    the device buffer). Host arrays go to the device without a sync; the
    step puts the head in training mode (cuDNN's LSTM backward needs it),
    updates it in place and returns the loss tensor. With ``mesh`` the step
    is data-parallel (module docstring); the head must be on its first
    device.
    """
    device = _device_of(head)
    cw = (torch.as_tensor(class_weights, dtype=torch.float32, device=device)
          if class_weights is not None else None)

    def loss_of(logits, latent, y):
        ce = masked_cross_entropy(logits, y, cw, label_smoothing)
        return ce + covariance_loss(latent, y >= 0)

    if mesh is None:
        def update(x: torch.Tensor, y: torch.Tensor, generator) -> torch.Tensor:
            head.train()
            optimizer.zero_grad(set_to_none=True)
            logits, latent = deltas_forward(head, x, generator)
            loss = loss_of(logits, latent, y)
            loss.backward()
            optimizer.step()
            return loss.detach()

        if gather_seq_len is None:
            def step(x: np.ndarray, y: np.ndarray, generator=None) -> torch.Tensor:
                return update(_to_device(x, device), _to_device(y.astype(np.int64), device),
                              generator)
        else:
            def step(features: torch.Tensor, centers: np.ndarray, y: np.ndarray,
                     generator=None) -> torch.Tensor:
                x = _gather_windows(
                    features, _to_device(centers.astype(np.int64), device), gather_seq_len
                )
                return update(x, _to_device(y.astype(np.int64), device), generator)
        return step

    replicas = _Replicas(head, mesh)

    def update_sharded(windows, n_rows: int, y: np.ndarray, generator) -> torch.Tensor:
        """``windows(rows, device)``: a shard's (rows, T, D) windows on its device."""
        replicas.refresh(train=True)
        optimizer.zero_grad(set_to_none=True)
        xs = replicas.run(lambda s, rows, d: windows(rows, d), n_rows)
        # Every mask of the global batch from the one generator, in the
        # single-device order; each shard takes its rows.
        masks = (dropout_masks(head.cfg, n_rows, xs[0].shape[1], generator, device)
                 if generator is not None else None)

        def features(s, rows, d):
            own = None if masks is None else [None if m is None else m[rows].to(d) for m in masks]
            return deltas_features(replicas.module(s), xs[s], None, masks=own)

        outs = replicas.run(features, n_rows)
        logits, latent = deltas_pool(head, torch.cat([lin.to(device) for lin, _ in outs]),
                                     torch.cat([seq.to(device) for _, seq in outs]))
        loss = loss_of(logits, latent, _to_device(y.astype(np.int64), device))
        loss.backward()
        replicas.gather_grads()
        optimizer.step()
        return loss.detach()

    if gather_seq_len is None:
        def step(x: np.ndarray, y: np.ndarray, generator=None) -> torch.Tensor:
            return update_sharded(lambda rows, d: _to_device(x[rows], d), len(x), y, generator)
    else:
        def step(features, centers: np.ndarray, y: np.ndarray, generator=None) -> torch.Tensor:
            def windows(rows, d):
                return _gather_windows(_on(features, d), _to_device(
                    centers[rows].astype(np.int64), d), gather_seq_len)

            return update_sharded(windows, len(centers), y, generator)
    return step


def build_logits_program(head: DeltasHead, gather_seq_len: Optional[int] = None, mesh=None):
    """Eval-mode logits, ``fn(x)`` on host windows or ``fn(features, centers)``
    on the device gather; returns a device tensor (B, C). With ``mesh`` the
    batch is split over its data axis and the logits gathered on its first
    device."""
    device = _device_of(head)

    if mesh is None:
        if gather_seq_len is None:
            @torch.inference_mode()
            def logits(x: np.ndarray) -> torch.Tensor:
                head.eval()
                return head(_to_device(x, device))[0]
        else:
            @torch.inference_mode()
            def logits(features: torch.Tensor, centers: np.ndarray) -> torch.Tensor:
                head.eval()
                x = _gather_windows(
                    features, _to_device(centers.astype(np.int64), device), gather_seq_len
                )
                return head(x)[0]
        return logits

    replicas = _Replicas(head, mesh)

    def sharded(windows, n_rows: int) -> torch.Tensor:
        replicas.refresh(train=False)
        outs = replicas.run(lambda s, rows, d: replicas.module(s)(windows(rows, d))[0], n_rows)
        return torch.cat([o.to(device) for o in outs])

    if gather_seq_len is None:
        @torch.inference_mode()
        def logits(x: np.ndarray) -> torch.Tensor:
            return sharded(lambda rows, d: _to_device(x[rows], d), len(x))
    else:
        @torch.inference_mode()
        def logits(features, centers: np.ndarray) -> torch.Tensor:
            return sharded(lambda rows, d: _gather_windows(
                _on(features, d), _to_device(centers[rows].astype(np.int64), d), gather_seq_len),
                len(centers))
    return logits


def collect_logits_source(
    logits_prog,
    source: WindowSource,
    sampler,
    batch_size: int,
    cancel_event: Optional[threading.Event] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(logits (N, C), labels (N,)) over a source's valid rows.

    The one batched-eval loop shared by prediction and temperature
    calibration: padded rows (beyond n_valid) and corrupt rows (label -1)
    are excluded under one rule. Logits stay on the device until the end.
    """
    zs: List[torch.Tensor] = []
    ys: List[np.ndarray] = []
    for x, y, n_valid in iter_batches(source, sampler, batch_size):
        if cancel_event is not None and cancel_event.is_set():
            break
        zs.append(logits_prog(x)[:n_valid])
        ys.append(y[:n_valid])
    if not zs:
        return np.zeros((0, 1), np.float32), np.array([], np.int32)
    logits = torch.cat(zs).float().cpu().numpy()
    labels = np.concatenate(ys)
    keep = labels >= 0
    return logits[keep], labels[keep]


def predict_source(
    logits_prog,
    source: WindowSource,
    sampler,
    batch_size: int,
    cancel_event: Optional[threading.Event] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(y_true, y_pred) over a source; padded/corrupt rows excluded."""
    logits, y_true = collect_logits_source(
        logits_prog, source, sampler, batch_size, cancel_event
    )
    if logits.size == 0:
        return np.array([], np.int32), np.array([], np.int32)
    return y_true, logits.argmax(1)


def predict_store(
    logits_prog,
    store: DeviceWindowStore,
    sampler,
    batch_size: int,
    cancel_event: Optional[threading.Event] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(y_true, y_pred) with windows gathered from the device-resident store;
    the argmax runs on the device and one copy brings the predictions back."""
    preds: List[torch.Tensor] = []
    labels: List[np.ndarray] = []
    indices = sampler.epoch_indices()
    for start in range(0, len(indices), batch_size):
        if cancel_event is not None and cancel_event.is_set():
            break
        centers, y = store.batch_indices(indices[start : start + batch_size], batch_size)
        preds.append(logits_prog(store.features, centers).argmax(1))
        labels.append(y)
    if not preds:
        return np.array([], np.int32), np.array([], np.int32)
    y_pred = torch.cat(preds).cpu().numpy()
    y_true = np.concatenate(labels)
    keep = y_true >= 0
    return y_true[keep], y_pred[keep]


# Device-resident training data is used when the stacked embeddings fit this
# budget of device memory (the encoder is long gone during training).
DEVICE_DATA_BUDGET_BYTES = 4 * 1024**3


def _manifest_bytes(manifest, ram=None) -> int:
    """Bytes the store would stack: a preload's span, or the whole fp16
    file (``h5py`` is imported only for a file outside ``ram``)."""
    total = 0
    for path in {e[0] for e in manifest}:
        if ram is not None and path in ram:
            total += ram[path][0].nbytes  # (span rows, offset) tuple
            continue
        import h5py

        with h5py.File(path, "r") as f:
            total += int(np.prod(f[DATASET_NAME].shape)) * 2  # fp16
    return total


# ---------------------------------------------------------------------------
# Mid-training checkpointing
# ---------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _snapshot(head: DeltasHead) -> Dict[str, torch.Tensor]:
    """A copy of the head's weights: ``state_dict`` tensors are live
    references, and a kept best epoch must not follow training."""
    return {k: v.detach().clone() for k, v in head.state_dict().items()}


def save_train_state(
    path: str,
    head: DeltasHead,
    optimizer: torch.optim.Optimizer,
    best_params: dict,
    meta: dict,
) -> None:
    """Persist (weights, Adam moments and step, best-so-far weights,
    metadata) as one ``.npz`` (no pickle), staged and renamed atomically.

    Keys: ``param/<name>``, ``exp_avg/<name>``, ``exp_avg_sq/<name>``,
    ``step/<name>``, ``best/<name>`` and the JSON ``__meta__``. The format
    is the port's own; a JAX package checkpoint does not load here.
    """
    arrays = {}
    for name, p in head.named_parameters():
        arrays[f"param/{name}"] = _numpy(p)
        state = optimizer.state.get(p)
        if state:
            arrays[f"exp_avg/{name}"] = _numpy(state["exp_avg"])
            arrays[f"exp_avg_sq/{name}"] = _numpy(state["exp_avg_sq"])
            arrays[f"step/{name}"] = np.asarray(float(state["step"]), np.float32)
    for name, v in best_params.items():
        arrays[f"best/{name}"] = _numpy(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_train_state(
    path: str, head: DeltasHead, optimizer: torch.optim.Optimizer
) -> Tuple[Params, dict]:
    """Restore a :func:`save_train_state` file into ``head`` and
    ``optimizer`` in place; returns (best params as numpy, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    head.load_state_dict({n: torch.from_numpy(arrays[f"param/{n}"]) for n in head.state_dict()})
    for name, p in head.named_parameters():
        if f"step/{name}" in arrays:
            optimizer.state[p] = {
                "step": torch.tensor(float(arrays[f"step/{name}"]), dtype=torch.float32),
                "exp_avg": torch.from_numpy(arrays[f"exp_avg/{name}"]).to(p.device),
                "exp_avg_sq": torch.from_numpy(arrays[f"exp_avg_sq/{name}"]).to(p.device),
            }
    best = {k[len("best/"):]: v for k, v in arrays.items() if k.startswith("best/")}
    return best, meta


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

def _host(params: dict) -> Params:
    return {k: _numpy(v) for k, v in params.items()}


def train_head(
    train_source: WindowSource,
    val_source: Optional[WindowSource],
    seq_len: int,
    behaviors: Sequence[str],
    cancel_event: Optional[threading.Event] = None,
    batch_size: int = 512,
    lr: float = 1e-4,
    epochs: int = 10,
    class_weights: Optional[np.ndarray] = None,
    patience: int = 3,
    progress_callback: Optional[Callable[[str], None]] = None,
    optimization_target: str = "weighted avg",
    weight_decay: float = 0.0,
    label_smoothing: float = 0.0,
    lstm_hidden_size: int = 64,
    lstm_layers: int = 1,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    device_data: bool = True,
    mesh=None,
    device="cuda",
) -> Tuple[Optional[Params], Optional[List[PerformanceReport]], int]:
    """Train a deltas head on ``device``, or data-parallel over ``mesh``'s
    data axis (``device`` is then the mesh's first device); returns (best
    params as a numpy dict keyed by ``state_dict`` names, reports,
    best_epoch).

    The JAX package's control flow: balanced oversampled train stream, full
    train+val evaluation each epoch, best-by-val-F1 with early stopping,
    per-batch cancellation. With ``checkpoint_path`` the full train state is
    persisted after every epoch, and ``resume=True`` continues an
    interrupted run from the last completed epoch.
    """
    if len(train_source) == 0:
        return None, None, -1
    if mesh is not None:
        from cbas_tpu_torch.parallel.mesh import check_devices, data_axis_size, pad_to_multiple

        check_devices(mesh)
        # Fixed-shape batches must divide the data axis; round the batch
        # size up (iter_batches / batch_indices already pad partial batches).
        batch_size = pad_to_multiple(batch_size, data_axis_size(mesh))
        device = mesh.first_device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_head(device='cuda') needs a CUDA device; none is visible")

    cancel_event = cancel_event or threading.Event()
    cfg = DeltasHeadConfig(
        in_features=train_source.embed_dim,
        out_features=len(behaviors),
        seq_len=seq_len,
        lstm_hidden_size=lstm_hidden_size,
        lstm_layers=lstm_layers,
    )
    # On the device first, then cuDNN's flat weight buffer, then the optimizer.
    head = deltas_params_from_numpy(init_deltas_params(seed, cfg), cfg, device)
    head.lstm.flatten_parameters()
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    has_val = val_source is not None and len(val_source) > 0

    # Device-resident data path: embeddings live on the device once and
    # windows are gathered inside the step (per-batch H2D = a few KB).
    train_store = val_store = None
    if device_data:
        try:
            train_ram = getattr(train_source, "_ram", None)
            val_ram = getattr(val_source, "_ram", None) if has_val else None
            total = _manifest_bytes(train_source.manifest, train_ram)
            if has_val:
                total += _manifest_bytes(val_source.manifest, val_ram)
            if total <= DEVICE_DATA_BUDGET_BYTES:
                train_store = DeviceWindowStore(
                    train_source.manifest, seq_len, device, ram=train_ram, mesh=mesh
                )
                if has_val:
                    val_store = DeviceWindowStore(
                        val_source.manifest, seq_len, device, ram=val_ram, mesh=mesh
                    )
        except Exception as e:
            print(f"Device-data path unavailable ({e}); using host windows.")
            train_store = val_store = None
    gather = seq_len if train_store is not None else None

    optimizer = make_optimizer(head, lr, weight_decay)
    step = build_train_step(
        head, optimizer, class_weights, label_smoothing, gather_seq_len=gather, mesh=mesh
    )
    logits_prog = build_logits_program(head, gather_seq_len=gather, mesh=mesh)

    train_sampler = BalancedSampler(train_source.manifest, len(behaviors), seed=seed)

    best_f1, best_params, best_epoch = -1.0, None, -1
    epoch_reports: List[PerformanceReport] = []
    no_improve = 0
    start_epoch = 0
    best_report_payload: Optional[dict] = None

    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        ckpt_best, meta = load_train_state(checkpoint_path, head, optimizer)
        start_epoch = int(meta["epoch"]) + 1
        best_f1 = float(meta["best_f1"])
        best_epoch = int(meta["best_epoch"])
        no_improve = int(meta["no_improve"])
        generator.manual_seed(seed + 7919 * start_epoch)  # fresh stream post-resume
        if best_epoch >= 0:
            # The checkpointed best weights, not the last epoch's.
            best_params = ckpt_best
        print(f"Resumed training from epoch {start_epoch} ({checkpoint_path}).")
        # Replay the sampler so epoch streams continue where they left off.
        for _ in range(start_epoch):
            train_sampler.epoch_indices()
        # Keep epoch_reports index-aligned with ABSOLUTE epoch numbers:
        # callers index reports[best_epoch], so the resumed-over epochs get
        # empty placeholders (plot series render them as gaps).
        epoch_reports.extend(
            PerformanceReport({}, np.array([]), {}, np.array([]))
            for _ in range(start_epoch)
        )
        best_report_payload = meta.get("best_reports")
        if best_report_payload and 0 <= best_epoch < start_epoch:
            # restore the real report at the checkpointed best epoch
            epoch_reports[best_epoch] = PerformanceReport(
                best_report_payload.get("train_report") or {},
                np.asarray(best_report_payload.get("train_cm") or []),
                best_report_payload.get("val_report") or {},
                np.asarray(best_report_payload.get("val_cm") or []),
            )
        if has_val and no_improve >= patience:
            # The checkpointed run had already early-stopped; training even
            # one more epoch would drift past the stop it committed to.
            print("Checkpoint is already early-stopped; not training further.")
            start_epoch = epochs

    def cancel_return():
        # Return only COMPLETE epochs' results. No-val runs never set
        # best_params inside the loop (nothing to compare); a cancel must
        # still return the trained-so-far weights.
        nonlocal best_params, best_epoch
        if best_params is None and not has_val and epoch_reports:
            best_params, best_epoch = _snapshot(head), len(epoch_reports) - 1
        return (_host(best_params) if best_params is not None else None,
                epoch_reports, best_epoch)

    for e in range(start_epoch, epochs):
        if cancel_event.is_set():
            return cancel_return()
        if progress_callback:
            progress_callback(f"Training Epoch {e + 1}/{epochs}...")

        if train_store is not None:
            epoch_idx = train_sampler.epoch_indices()
            for i, start in enumerate(range(0, len(epoch_idx), batch_size)):
                if cancel_event.is_set():
                    break
                centers, labels = train_store.batch_indices(
                    epoch_idx[start : start + batch_size], batch_size
                )
                with metrics.timed(TRAIN_STEPS):
                    loss = step(train_store.features, centers, labels, generator)
                if i % 50 == 0:
                    print(f"[Epoch {e + 1}/{epochs} Batch {i}] Loss: {float(loss):.4f}")
        else:
            for i, (x, y, _) in enumerate(iter_batches(train_source, train_sampler, batch_size)):
                if cancel_event.is_set():
                    break
                with metrics.timed(TRAIN_STEPS):
                    loss = step(x, y, generator)
                if i % 50 == 0:
                    print(f"[Epoch {e + 1}/{epochs} Batch {i}] Loss: {float(loss):.4f}")

        if cancel_event.is_set():
            # Canceled mid-epoch: skip evaluation entirely.
            return cancel_return()

        # Per-epoch evaluation (balanced train stream + sequential val).
        eval_sampler = BalancedSampler(
            train_source.manifest, len(behaviors), seed=seed + 1000 + e
        )
        if train_store is not None:
            t_true, t_pred = predict_store(
                logits_prog, train_store, eval_sampler, batch_size, cancel_event
            )
        else:
            t_true, t_pred = predict_source(
                logits_prog, train_source, eval_sampler, batch_size, cancel_event
            )
        if cancel_event.is_set():
            # Cancel landed during the train-set eval: t_true is a truncated
            # prefix (or empty); don't record it or count it as no_improve.
            return cancel_return()
        if t_true.size == 0:
            # Keep reports index-aligned with epoch numbers even for a
            # skipped evaluation (callers index reports[best_epoch]).
            epoch_reports.append(PerformanceReport({}, np.array([]), {}, np.array([])))
            no_improve += 1
            if no_improve >= patience:
                break
            continue
        train_report, train_cm = report_and_cm(t_true, t_pred, behaviors)

        val_report, val_cm = {}, np.array([])
        if has_val:
            if val_store is not None:
                v_true, v_pred = predict_store(
                    logits_prog, val_store,
                    SequentialSampler(len(val_source)), batch_size, cancel_event,
                )
            else:
                v_true, v_pred = predict_source(
                    logits_prog, val_source,
                    SequentialSampler(len(val_source)), batch_size, cancel_event,
                )
            if v_true.size:
                val_report, val_cm = report_and_cm(v_true, v_pred, behaviors)

        if cancel_event.is_set():
            # A cancel during evaluation truncated the predict loops: a
            # partial prefix could beat the genuine best_f1, and an empty val
            # eval would inflate no_improve. Discard the epoch's evaluation.
            return cancel_return()

        epoch_reports.append(PerformanceReport(train_report, train_cm, val_report, val_cm))

        cur_val = f1_of(val_report, optimization_target)
        cur_train = f1_of(train_report, optimization_target)
        val_str = f"{cur_val:.4f}" if has_val else "N/A"
        if progress_callback:
            progress_callback(f"Epoch {e + 1} Val F1: {val_str}")
        print(
            f"--- Epoch {e + 1} | Train F1: {cur_train:.4f} | Val F1: {val_str} "
            f"({optimization_target}) ---"
        )

        if cur_val > best_f1:
            best_f1, best_epoch = cur_val, e
            best_params = _snapshot(head)
            no_improve = 0
            # Checkpoint the best epoch's REPORTS too: a resumed run that
            # never improves must still return a real report at best_epoch.
            best_report_payload = {
                "train_report": train_report, "train_cm": train_cm.tolist(),
                "val_report": val_report, "val_cm": val_cm.tolist(),
            }
        else:
            no_improve += 1

        if checkpoint_path:
            save_train_state(
                checkpoint_path, head, optimizer,
                best_params if best_params is not None else head.state_dict(),
                {"epoch": e, "best_f1": best_f1, "best_epoch": best_epoch,
                 "no_improve": no_improve, "seed": seed,
                 "best_reports": best_report_payload},
            )

        if has_val and no_improve >= patience:
            print(f"Early stopping triggered at epoch {e + 1}.")
            break

    if best_params is None and epochs > 0 and not has_val and epoch_reports:
        best_params, best_epoch = _snapshot(head), len(epoch_reports) - 1
    if best_params is None:
        return None, None, -1
    return _host(best_params), epoch_reports, best_epoch


def evaluate_on_split(
    params: Params,
    cfg: DeltasHeadConfig,
    source: WindowSource,
    behaviors: Sequence[str],
    batch_size: int = 512,
    device="cuda",
) -> dict:
    """One-shot evaluation on ``device``: {"report": ..., "cm": ...}."""
    logits_prog = build_logits_program(deltas_params_from_numpy(params, cfg, device))
    y_true, y_pred = predict_source(
        logits_prog, source, SequentialSampler(len(source)), batch_size
    )
    if y_true.size == 0:
        return {"report": {}, "cm": np.array([])}
    rep, cm = report_and_cm(y_true, y_pred, behaviors)
    return {"report": rep, "cm": cm}
