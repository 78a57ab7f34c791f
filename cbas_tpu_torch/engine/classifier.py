"""ClassifierBundle: a head-model bundle, runnable in PyTorch.

Port of ``cbas_tpu/engine/classifier.py``. Bundles are the same
self-describing directories, written in the same order:

    config.yaml        name / behaviors / seq_len / architecture
    model_meta.json    schema, encoder id, head version, hyperparams, calibration
    model.pth          torch state_dict
    model.npz          native weights, written last (a live reloader that sees
                       a fresh npz also sees the matching metadata)

so either package loads the other's bundles. Loading trusts weight shapes
over metadata and refuses a bundle trained on another encoder. Legacy v2
bundles (``ClassifierLegacyLSTM``) run their head for inference.

The file formats are ``cbas_tpu``'s (yaml, torch checkpoint I/O, encoder
identities), imported inside :meth:`ClassifierBundle.save` and
:meth:`ClassifierBundle.load`: a bundle built in memory runs its head without
importing anything of ``cbas_tpu``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from cbas_tpu_torch.models.convert import deltas_params_from_numpy, legacy_params_from_numpy
from cbas_tpu_torch.models.heads import (
    DeltasHead,
    DeltasHeadConfig,
    LegacyHead,
    LegacyHeadConfig,
    infer_deltas_hparams,
    legacy_forward_nodrop,
)

DELTAS_ARCH = "ClassifierLSTMDeltas"
LEGACY_ARCH = "ClassifierLegacyLSTM"


@dataclass
class ClassifierBundle:
    """Everything needed to run (or re-save) a trained behavior classifier."""

    name: str
    behaviors: List[str]
    seq_len: int
    params: Dict[str, np.ndarray]
    architecture: str = DELTAS_ARCH
    lstm_hidden_size: int = 64
    lstm_layers: int = 1
    use_acceleration: bool = True
    temperature: float = 1.0
    encoder_identifier: Optional[str] = None
    meta: dict = field(default_factory=dict)

    # -- persistence ---------------------------------------------------------

    def save(self, model_dir: str, extra_meta: Optional[dict] = None) -> None:
        """Write metadata first and weights last, each file staged to a tmp
        name and renamed, so no reader sees a partial file or new weights
        with old metadata."""
        from cbas_tpu_torch.core.config import dump_yaml
        from cbas_tpu_torch.models.torch_port import save_pth

        os.makedirs(model_dir, exist_ok=True)

        def _replace(write_fn, name: str) -> None:
            stem, ext = os.path.splitext(name)  # np.savez appends .npz otherwise
            tmp = os.path.join(model_dir, f"{stem}.tmp{ext}")
            write_fn(tmp)
            os.replace(tmp, os.path.join(model_dir, name))

        _replace(
            lambda p: dump_yaml(
                {
                    "name": self.name,
                    "behaviors": self.behaviors,
                    "seq_len": self.seq_len,
                    "architecture": self.architecture,
                },
                p,
            ),
            "config.yaml",
        )

        meta = {
            "model_bundle_schema": "1.0",
            "encoder_model_identifier": self.encoder_identifier,
            "head_architecture_version": self.architecture,
            "hyperparameters": {
                "behaviors": self.behaviors,
                "seq_len": self.seq_len,
                "use_acceleration": self.use_acceleration,
                "lstm_hidden_size": self.lstm_hidden_size,
                "lstm_layers": self.lstm_layers,
            },
            "calibration": {"temperature": float(self.temperature)},
        }
        if extra_meta:
            meta.update(extra_meta)

        def _write_meta(p: str) -> None:
            with open(p, "w", encoding="utf-8") as f:
                json.dump(meta, f, indent=4)

        _replace(_write_meta, "model_meta.json")
        _replace(lambda p: save_pth(self.params, p), "model.pth")
        host_params = {k: np.asarray(v) for k, v in self.params.items()}
        _replace(lambda p: np.savez(p, **host_params), "model.npz")

    @classmethod
    def load(cls, model_dir: str, expected_encoder: Optional[str] = None) -> "ClassifierBundle":
        from cbas_tpu_torch.core.config import load_yaml
        from cbas_tpu_torch.models.torch_port import load_pth
        from cbas_tpu_torch.utils.logging import log_message
        from cbas_tpu_torch.utils.naming import identities_equivalent

        config = dict(load_yaml(os.path.join(model_dir, "config.yaml")) or {})

        meta_path = os.path.join(model_dir, "model_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json.load(f)
        else:
            # Legacy bundle: default to the v2 head.
            meta = {
                "head_architecture_version": LEGACY_ARCH,
                "hyperparameters": dict(config or {}),
            }

        model_encoder = meta.get("encoder_model_identifier")
        if (
            expected_encoder
            and model_encoder
            and not identities_equivalent(model_encoder, expected_encoder)
        ):
            raise ValueError(
                f"Encoder mismatch: project uses '{expected_encoder}' but model "
                f"was trained with '{model_encoder}'. Re-encode videos or switch encoders."
            )

        npz_path = os.path.join(model_dir, "model.npz")
        if os.path.exists(npz_path):
            with np.load(npz_path) as z:
                params = {k: z[k] for k in z.files}
        else:
            params = load_pth(os.path.join(model_dir, "model.pth"))

        hp = dict(meta.get("hyperparameters") or {})
        behaviors = list(hp.get("behaviors") or config.get("behaviors", []))
        seq_len = int(hp.get("seq_len") or config.get("seq_len", 31))
        arch = meta.get("head_architecture_version", LEGACY_ARCH)

        if arch.startswith(DELTAS_ARCH):
            # Weight shapes are ground truth; a deltas-only sentinel key tells
            # a mid-save read of another architecture from a deltas bundle.
            if "cls_bottleneck.0.weight" not in params or "lin2.weight" not in params:
                raise ValueError(
                    f"Bundle '{os.path.basename(model_dir)}' metadata says "
                    f"'{arch}' but the weights on disk are a different "
                    "architecture — metadata and weights are out of sync "
                    "(mid-save read?). Retry the load."
                )
            inferred = infer_deltas_hparams(params)
            hidden = int(inferred["lstm_hidden_size"])
            layers = int(inferred["lstm_layers"])
            meta_hidden = hp.get("lstm_hidden_size")
            if meta_hidden and int(meta_hidden) != hidden:
                log_message(
                    f"Bundle '{os.path.basename(model_dir)}' metadata says "
                    f"lstm_hidden_size={meta_hidden} but weights are {hidden} "
                    "(stale metadata mid-save?); using weight shapes.",
                    "WARN",
                )
            use_acc = "acc_bottleneck.0.weight" in params
            arch = DELTAS_ARCH
            out_dim = int(params["lin2.weight"].shape[0])
            if behaviors and len(behaviors) != out_dim:
                raise ValueError(
                    f"Bundle '{os.path.basename(model_dir)}' lists "
                    f"{len(behaviors)} behaviors but the output layer is "
                    f"{out_dim}-wide — metadata and weights are out of sync "
                    "(mid-save read?). Retry the load."
                )
        else:
            hidden, layers, use_acc, arch = 64, 1, False, LEGACY_ARCH

        return cls(
            name=os.path.basename(model_dir),
            behaviors=behaviors,
            seq_len=seq_len,
            params=params,
            architecture=arch,
            lstm_hidden_size=hidden,
            lstm_layers=layers,
            use_acceleration=use_acc,
            temperature=float((meta.get("calibration") or {}).get("temperature", 1.0)),
            encoder_identifier=model_encoder,
            meta=meta,
        )

    # -- running the head ----------------------------------------------------

    def head_config(self) -> Union[DeltasHeadConfig, LegacyHeadConfig]:
        if self.architecture == DELTAS_ARCH:
            return DeltasHeadConfig(
                in_features=int(self.params["lin1.weight"].shape[1]),
                out_features=len(self.behaviors),
                seq_len=self.seq_len,
                lstm_hidden_size=self.lstm_hidden_size,
                lstm_layers=self.lstm_layers,
                use_acceleration=self.use_acceleration,
            )
        return LegacyHeadConfig(
            in_features=int(self.params["lin1.weight"].shape[1]),
            out_features=len(self.behaviors),
            seq_len=self.seq_len,
            lstm_input=int(self.params["lin0.weight"].shape[0]),
        )

    def head(self, device="cuda") -> Union[DeltasHead, LegacyHead]:
        """The head as an eval-mode module on ``device``."""
        if self.architecture == DELTAS_ARCH:
            return deltas_params_from_numpy(self.params, self.head_config(), device)
        return legacy_params_from_numpy(self.params, self.head_config(), device)

    def logits_fn(self, device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
        """fn(windows (B, T, D) f32) -> logits (B, C), head built once on ``device``."""
        head = self.head(device)
        if self.architecture == DELTAS_ARCH:
            return lambda x: head(x)[0]
        return lambda x: legacy_forward_nodrop(head, x)

    def probs_fn(self, device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
        """fn(windows) -> calibrated (temperature) softmax probabilities."""
        base = self.logits_fn(device)
        temp = max(1e-3, float(self.temperature))
        return lambda x: torch.softmax(base(x) / temp, dim=-1)
