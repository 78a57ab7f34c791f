"""torch ``state_dict`` ⇄ JAX params conversion.

Copy of ``cbas_tpu/models/torch_port.py`` for the port, which imports nothing of ``cbas_tpu``;
``tests/test_torch_copies.py`` holds the two equal.

Head params use torch key layout natively (see models/heads.py), so conversion
is a dtype/array-type hop. torch is an *optional* dependency used only for
reading/writing reference-compatible ``model.pth`` bundles; everything else in
the framework runs without it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_SKIP_SUFFIXES = ("num_batches_tracked",)


def state_dict_to_params(state_dict) -> Dict[str, np.ndarray]:
    """torch state_dict -> flat numpy params (torch not required to hold result)."""
    params: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if any(k.endswith(s) for s in _SKIP_SUFFIXES):
            continue
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        params[k] = arr
    return params


def params_to_state_dict(params: Dict[str, np.ndarray]):
    """Flat params -> torch state_dict (requires torch)."""
    import torch

    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in params.items()}


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """Read a reference ``model.pth`` into numpy params."""
    import torch

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except TypeError:
        sd = torch.load(path, map_location="cpu")
    return state_dict_to_params(sd)


def save_pth(params: Dict[str, np.ndarray], path: str) -> None:
    import torch

    torch.save(params_to_state_dict(params), path)


def torch_available() -> bool:
    try:
        import torch  # noqa: F401

        return True
    except Exception:
        return False
