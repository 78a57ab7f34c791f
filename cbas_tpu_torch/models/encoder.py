"""FrameEncoder: decoded video frames -> CLS embeddings, on one device or a mesh.

Port of ``cbas_tpu/models/encoder.py``. One forward per batch performs

    uint8 green plane -> [0,1] scale -> single-plane patch projection
    (channel-folded kernel) -> ViT blocks (last one CLS-only) -> CLS -> float16

- Host->device traffic is 1 byte/pixel (uint8 plane), copied from pinned host
  memory without blocking, so the copy queues behind the previous batch's
  compute.
- Compute runs in bfloat16 by default (float32 for parity tests); the output
  is float16 either way, as the HDF5 store keeps it.
- Partial batches are zero-padded to the requested batch and sliced after.
- Per-geometry state (RoPE tables or the resampled position table) is built
  once per (batch, height, width).
- With a mesh (``parallel/mesh.py``) the batch is padded to a multiple of
  the data axis and split over it: a data-only mesh replicates the weights
  on each device; a (data, model) mesh cuts them by ``parallel/tp.py``'s
  rules, so each shard holds only its heads and intermediate columns. Each
  shard's rows go straight from pinned memory to its device, and each shard
  runs in its own thread; the embeddings are gathered on the mesh's first
  device.

PyTorch runs eagerly: ``encode_planes_async`` returns once the work is
queued on the device, and :meth:`to_host` waits for it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cbas_tpu_torch.models.convert import (
    check_vit_params,
    params_to_device,
    vit_params_from_numpy,
)
from cbas_tpu_torch.models.vit import (
    ViTConfig,
    config_for_identifier,
    fuse_qkv,
    init_vit_params,
    resample_pos_embed,
    rope_tables,
    vit_forward_from_tokens,
)
from cbas_tpu_torch.ops.preprocess import (
    extract_green_plane,
    fold_channels_into_patch_kernel,
    normalize_plane,
    patchify_plane,
)
from cbas_tpu_torch.utils.naming import canonical_encoder_identity


class EncoderWeightsUnavailable(RuntimeError):
    pass


def load_encoder_params(identifier: str) -> Dict[str, np.ndarray]:
    """Load pretrained ViT weights as numpy params from local files only:
    a safetensors/pth file, a directory holding one, or the HF cache with
    ``local_files_only``. Never downloads; raises
    :class:`EncoderWeightsUnavailable` otherwise."""
    candidates = []
    if os.path.isfile(identifier):
        candidates.append(identifier)
    elif os.path.isdir(identifier):
        for name in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(identifier, name)
            if os.path.exists(p):
                candidates.append(p)

    for path in candidates:
        if path.endswith(".safetensors"):
            from safetensors.numpy import load_file

            return dict(load_file(path))
        from cbas_tpu_torch.models.torch_port import load_pth

        return load_pth(path)

    try:
        import transformers

        model = transformers.AutoModel.from_pretrained(identifier, local_files_only=True)
        from cbas_tpu_torch.models.torch_port import state_dict_to_params

        return state_dict_to_params(model.state_dict())
    except Exception as e:
        raise EncoderWeightsUnavailable(
            f"Could not load encoder weights for '{identifier}' from local files "
            f"or the HF cache ({type(e).__name__}: {e}). Download the checkpoint "
            "or pass random_init=True for testing."
        ) from e


class _Shard:
    """One mesh shard's copy of what the forward reads, on its device."""

    def __init__(self, device: torch.device, params: Dict[str, torch.Tensor],
                 plane_kernel: torch.Tensor):
        self.device, self.params, self.plane_kernel = device, params, plane_kernel


class FrameEncoder:
    """Frozen ViT frame encoder on one device or a mesh, with per-geometry
    state cached."""

    def __init__(
        self,
        identifier: str,
        params: Optional[Dict[str, np.ndarray]] = None,
        cfg: Optional[ViTConfig] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        random_init: bool = False,
        mesh=None,
        fast_gelu: Optional[bool] = None,
        device="cuda",
    ):
        """``mesh`` (``parallel/mesh.py``) runs the encoder on its devices
        (``device`` is then its first one); without it, on ``device``."""
        self.mesh = mesh
        if mesh is not None:
            from cbas_tpu_torch.parallel.mesh import check_devices

            check_devices(mesh)
            device = mesh.first_device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FrameEncoder(device='cuda') needs a CUDA device; none is visible")
        # The stamped identity is machine-independent (basename for local
        # checkpoint dirs); weight loading below uses the raw identifier.
        self.identifier = canonical_encoder_identity(identifier)
        self.cfg = cfg or config_for_identifier(identifier)
        # tanh-GELU on the bf16 path: its deviation (~1e-3 rel) sits below
        # the fp16 embedding store's rounding. fp32 runs stay exact.
        if fast_gelu is None:
            fast_gelu = compute_dtype == torch.bfloat16
        if fast_gelu and not self.cfg.gelu_approximate:
            self.cfg = dataclasses.replace(self.cfg, gelu_approximate=True)
        self.compute_dtype = compute_dtype
        if params is None:
            params = init_vit_params(0, self.cfg) if random_init else load_encoder_params(identifier)
        params_np = {k: np.asarray(v) for k, v in params.items()}
        self.embed_dim = self.cfg.hidden_size

        # Channel-folded single-plane patch kernel (see ops/preprocess.py).
        conv_key = (
            "embeddings.patch_embeddings.projection.weight" if self.cfg.variant == "dinov2"
            else "embeddings.patch_embeddings.weight"
        )
        self._patch_bias_key = conv_key[: -len("weight")] + "bias"
        plane_kernel = fold_channels_into_patch_kernel(params_np[conv_key])
        # dinov2's position table is resampled per geometry on the host.
        self._pos_table = (
            params_np.get("embeddings.position_embeddings") if self.cfg.variant == "dinov2"
            else None
        )
        # The forward never reads the raw (D,3,p,p) conv weight (folded
        # above), the position table (resampled per geometry) nor the
        # masked-image-modelling token every Hugging Face DINO checkpoint
        # carries: keeping them on the device would pin dead memory.
        dead = {conv_key, "embeddings.position_embeddings", "embeddings.mask_token"}
        live = {k: a for k, a in params_np.items() if k not in dead}
        self._shards = self._place(live, plane_kernel)
        self._params = self._shards[0][0].params
        self._plane_kernel = self._shards[0][0].plane_kernel
        self._geometry_cache: dict = {}

    def _place(self, live: Dict[str, np.ndarray], plane_kernel: np.ndarray):
        """The shards as a (data, model) grid of :class:`_Shard`: one device
        without a mesh; the weights replicated on each device of a data-only
        mesh; a (data, model) mesh's weights cut by ``parallel/tp.py``'s
        rules, model shard j's slices on each device of column j. Shards on
        one device with the same slices share one copy. Each copy's q, k and
        v projections are fused into one (``vit.fuse_qkv``), after the cut:
        a model shard fuses its own heads."""
        if self.mesh is None:
            params = vit_params_from_numpy(live, self.cfg, self.device, self.compute_dtype)
            kernel = torch.from_numpy(plane_kernel).to(self.device, self.compute_dtype)
            return [[_Shard(self.device, params, kernel)]]
        from cbas_tpu_torch.parallel.tp import shard_vit_params, vit_param_pspecs

        check_vit_params(live, self.cfg)  # the full shapes, before any slicing
        grid = self.mesh.grid()
        n_model = grid.shape[1]
        by_rank = [live]
        if n_model > 1:
            specs = vit_param_pspecs(live, self.mesh, self.cfg.head_dim)
            by_rank = shard_vit_params(live, specs, n_model)
        placed: dict = {}
        shards = []
        for i in range(grid.shape[0]):
            row = []
            for j in range(n_model):
                dev = grid[i][j]
                if (dev, j) not in placed:
                    placed[(dev, j)] = _Shard(
                        dev, fuse_qkv(params_to_device(by_rank[j], dev, self.compute_dtype),
                                      self.cfg),
                        torch.from_numpy(plane_kernel).to(dev, self.compute_dtype))
                row.append(placed[(dev, j)])
            shards.append(row)
        return shards

    # -- per-geometry state ---------------------------------------------------

    def _build(self, height: int, width: int) -> dict:
        """The geometry's state on each device of the shards."""
        p = self.cfg.patch_size
        grid = (height // p, width // p)
        devices = list(dict.fromkeys(s.device for row in self._shards for s in row))
        if self.cfg.variant == "dinov2":
            pos = torch.from_numpy(resample_pos_embed(self._pos_table, *grid))
            return {d: {"pos_embed": pos.to(d, self.compute_dtype)} for d in devices}
        cos, sin = (torch.from_numpy(t) for t in rope_tables(self.cfg, *grid))
        return {d: {"rope": (cos.to(d), sin.to(d))} for d in devices}

    def _geometry(self, batch: int, height: int, width: int):
        """Returns (state by device, was_cached); the first request per
        geometry builds it."""
        key = (batch, height, width)
        state = self._geometry_cache.get(key)
        if state is None:
            state = self._geometry_cache[key] = self._build(height, width)
            return state, False
        return state, True

    @torch.inference_mode()
    def _forward(self, shard: _Shard, plane_u8: torch.Tensor, state: dict) -> torch.Tensor:
        x = normalize_plane(plane_u8, self.compute_dtype)
        tokens = F.linear(
            patchify_plane(x, self.cfg.patch_size),
            shard.plane_kernel,
            shard.params[self._patch_bias_key],
        )
        hidden = vit_forward_from_tokens(
            shard.params, tokens, self.cfg,
            pos_embed=state.get("pos_embed"), rope=state.get("rope"), cls_only=True,
        )
        return hidden[:, 0, :].to(torch.float16)

    def _run_mesh(self, host: torch.Tensor, state: dict) -> torch.Tensor:
        """One padded batch over the mesh: gathered on its first device."""
        from cbas_tpu_torch.parallel.mesh import shard_batch, shard_batch_2d

        def fn(shard, planes):
            return self._forward(shard, planes, state[shard.device])

        if len(self._shards[0]) > 1:  # a model axis: tensor-parallel shards
            return shard_batch_2d(fn, self.mesh)(self._shards, host)
        return shard_batch(fn, self.mesh)([row[0] for row in self._shards], host)

    # -- public API -----------------------------------------------------------

    @property
    def weights_device(self) -> str:
        """The device every weight tensor lies on, e.g. "cuda:0"; with a mesh,
        its distinct devices joined by commas, e.g. "cuda:0,cuda:1". Raises if
        one shard's weights are split over devices."""
        devices = {}
        for row in self._shards:
            for shard in row:
                found = {str(t.device) for t in shard.params.values()}
                found.add(str(shard.plane_kernel.device))
                if len(found) != 1:
                    raise RuntimeError(f"encoder weights are split over {sorted(found)}")
                devices[found.pop()] = True
        return ",".join(devices)

    def encode_planes_async(self, planes_u8: np.ndarray, batch: Optional[int] = None):
        """Queue one batch without waiting: (device_tensor, n_valid, was_warm).

        ``was_warm`` is False when this call built the state for a new
        geometry. With a mesh the batch is padded to a multiple of its data
        axis. Resolve with :meth:`to_host`.
        """
        n, h, w = planes_u8.shape
        padded = batch or n
        if n > padded:
            raise ValueError(f"{n} planes do not fit a batch of {padded}")
        if self.mesh is not None:
            from cbas_tpu_torch.parallel.mesh import data_axis_size, pad_to_multiple

            # The batch splits over the data axis; the pad is sliced off by to_host.
            padded = pad_to_multiple(padded, data_axis_size(self.mesh))
        state, was_warm = self._geometry(padded, h, w)
        on_gpu = self.device.type == "cuda"
        host = torch.empty((padded, h, w), dtype=torch.uint8, pin_memory=on_gpu)
        host[:n].copy_(torch.from_numpy(np.ascontiguousarray(planes_u8)))
        host[n:].zero_()
        if self.mesh is not None:
            return self._run_mesh(host, state), n, was_warm
        # A pinned source makes the upload asynchronous; the caching host
        # allocator keeps the buffer alive until the copy has run.
        planes = host.to(self.device, non_blocking=on_gpu)
        return self._forward(self._shards[0][0], planes, state[self.device]), n, was_warm

    @staticmethod
    def to_host(pending) -> np.ndarray:
        out, n, _ = pending
        return out[:n].cpu().numpy()

    def encode_planes(self, planes_u8: np.ndarray, batch: Optional[int] = None) -> np.ndarray:
        """uint8 green planes (B, H, W) -> float16 CLS embeddings (B, D)."""
        return self.to_host(self.encode_planes_async(planes_u8, batch))

    def encode_rgb(self, frames_rgb: np.ndarray, batch: Optional[int] = None) -> np.ndarray:
        """uint8 RGB frames (B, H, W, 3) -> float16 CLS embeddings (B, D)."""
        return self.encode_planes(extract_green_plane(frames_rgb), batch)

    def __call__(self, frames_rgb: np.ndarray) -> np.ndarray:
        return self.encode_rgb(frames_rgb)
