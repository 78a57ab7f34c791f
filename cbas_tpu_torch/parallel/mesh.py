"""Device mesh and sharded execution, in one process.

Port of ``cbas_tpu/parallel/mesh.py``. The JAX package runs one controller
over many devices: ``shard_map`` runs the whole program on each shard and
``psum`` joins the partial sums. The port keeps that shape without
``torch.distributed``: one Python process, one worker thread per mesh shard
(each on its own device and that device's stream), and the collectives
inside the process (:class:`AllReduce`). The app's ``Api`` holds one encoder,
so the shards cannot be processes of their own.

- :func:`make_mesh` may list one device several times: logical shards, the
  counterpart of JAX's virtual CPU devices. The CPU tests use them, and so
  does ``chip_smoke.py`` on a one-card machine. :func:`runtime_mesh` never
  repeats a device and builds meshes of CUDA devices only.
- :func:`shard_batch` splits a batch on the data axis, runs a function on
  every shard in its thread and gathers the outputs on the mesh's first
  device; :func:`shard_batch_2d` adds the model axis, over which the ViT's
  out-projection partials are summed inside the forward
  (``models/vit.py::tp_psum_axis``).
- A shard's exception aborts every barrier of the run and is raised in the
  caller: a failing shard cannot hang the others, and nothing falls back to
  another device.
"""

from __future__ import annotations

import threading
from contextlib import ExitStack
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An array of ``torch.device`` with a name for each axis. ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices with axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def grid(self, data_axis: str = "data", model_axis: str = "model") -> np.ndarray:
        """The devices as a (data, model) array; an absent axis has size 1."""
        shape = self.shape
        if set(shape) - {data_axis, model_axis}:
            raise ValueError(f"a mesh over {self.axis_names} has axes other than "
                             f"{data_axis!r} and {model_axis!r}")
        order = [a for a in (data_axis, model_axis) if a in shape]
        devs = np.moveaxis(self.devices, [self.axis_names.index(a) for a in order],
                           list(range(len(order))))
        return devs.reshape(shape.get(data_axis, 1), shape.get(model_axis, 1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without an index names the
    current CUDA device (cuda:0 where none is visible), as tensors report
    it, so a mesh's devices compare equal to its tensors' devices."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device) in
    ``shape`` (default: one axis over all of them). A device may be listed
    several times: each entry is a shard of its own. "cuda" without an
    index is the current CUDA device."""
    devices = [_indexed(d) for d in (devices if devices is not None else _cuda_devices())]
    if not devices:
        raise RuntimeError("make_mesh: no devices (no CUDA device is visible)")
    if shape is None:
        shape = (len(devices),)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Batch-padding granularity: the size of the data axis (the full device
    count on a 1-D mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get("data", mesh.devices.size))


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def runtime_mesh(runtime_config=None) -> Optional[Mesh]:
    """The production mesh, from :class:`core.config.RuntimeConfig`, over the
    visible CUDA devices.

    Returns ``None`` (plain single-device execution) when one device is
    visible and no shape was configured; several visible devices and no
    shape give one data axis over all of them. Raises ``ValueError`` when the
    shape needs more devices than are visible.
    """
    devices = _cuda_devices()
    shape = getattr(runtime_config, "mesh_shape", None)
    axis_names = tuple(getattr(runtime_config, "mesh_axis_names", None) or ("data",))
    if shape is None:
        if len(devices) < 2:
            return None
        shape = (len(devices),)
        axis_names = ("data",)
    if len(axis_names) != len(shape):
        # Config gave a shape without (enough) axis names: default them, so
        # `mesh_shape: [4, 2]` alone means DP x TP rather than a Mesh error.
        axis_names = ("data", "model")[: len(shape)] if len(shape) <= 2 else tuple(
            f"axis{i}" for i in range(len(shape))
        )
    n = int(np.prod(shape))
    if n == 1:
        return None
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}"
        )
    return make_mesh(tuple(shape), axis_names, devices[:n])


def check_devices(mesh: Mesh) -> None:
    """Raise ``RuntimeError`` naming a CUDA device of ``mesh`` that is not
    visible; a mesh never falls back to fewer devices or to the CPU."""
    for d in mesh.distinct_devices():
        if d.type == "cuda" and not (torch.cuda.is_available()
                                     and (d.index or 0) < torch.cuda.device_count()):
            raise RuntimeError(f"the mesh needs {d}, which is not visible "
                               f"({torch.cuda.device_count()} CUDA devices)")


# ---------------------------------------------------------------------------
# Running on the shards
# ---------------------------------------------------------------------------

def run_shards(fns: Sequence[Callable[[], object]], devices: Sequence[torch.device],
               barriers: Sequence[threading.Barrier] = ()) -> list:
    """Run ``fns[i]()`` in a thread of its own on ``devices[i]``; return the
    results in order.

    Each thread enters what PyTorch keeps per thread: the caller's grad and
    inference modes, its device, and the caller's current stream on every
    CUDA device of the run (so a tensor made by one shard and read by
    another is ordered on one stream per device). The first exception of a
    shard aborts ``barriers`` (waking shards that wait on them) and is
    raised here once every thread has ended.
    """
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
    cuda = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    streams = [torch.cuda.current_stream(d) for d in cuda]
    results: list = [None] * len(fns)
    errors: list = [None] * len(fns)

    def work(i):
        try:
            with ExitStack() as ctx:
                ctx.enter_context(torch.inference_mode(inference))
                ctx.enter_context(torch.set_grad_enabled(grad))
                for s in streams:
                    ctx.enter_context(torch.cuda.stream(s))
                if devices[i].type == "cuda":
                    ctx.enter_context(torch.cuda.device(devices[i]))
                results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            errors[i] = e
            for b in barriers:
                b.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"cbas-shard-{i}", daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        # The shard that failed first, not those its abort woke.
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return results


class AllReduce:
    """The sum of one tensor from each shard of a group, given back to every
    shard on its own device: ``reduce(rank, t)`` is called once by each
    shard's thread. Partials of logical shards of one device are summed
    there; distinct CUDA devices are joined by ``torch.cuda.comm.reduce_add``
    onto the first rank's device and ``broadcast`` back. The order of the
    sum is fixed (rank order), so every call gives the same bits."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.barrier = threading.Barrier(len(self.devices))
        self._parts: list = [None] * len(self.devices)
        self._out: Dict[torch.device, torch.Tensor] = {}

    def __call__(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        self._parts[rank] = t
        self.barrier.wait()  # every partial is posted
        if rank == 0:
            self._out = self._sum(self._parts)
        self.barrier.wait()  # the sum is ready; nobody posts again before reading it
        return self._out[self.devices[rank]]

    def _sum(self, parts) -> Dict[torch.device, torch.Tensor]:
        by_device: Dict[torch.device, torch.Tensor] = {}
        for dev, t in zip(self.devices, parts):
            by_device[dev] = t if dev not in by_device else by_device[dev] + t
        if len(by_device) == 1:
            return by_device
        devs = list(by_device)
        if any(d.type != "cuda" for d in devs):
            total = sum(by_device[d].to(devs[0]) for d in devs)
            return {d: total.to(d) for d in devs}
        total = torch.cuda.comm.reduce_add([by_device[d] for d in devs], destination=devs[0])
        return dict(zip(devs, torch.cuda.comm.broadcast(total, devs)))


def _split_rows(batch: torch.Tensor, parts: int) -> List[torch.Tensor]:
    if batch.shape[0] % parts:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over {parts} data shards "
                         "(callers pad to data_axis_size)")
    return list(batch.split(batch.shape[0] // parts))


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=t.device.type == "cpu" and t.is_pinned())


def shard_batch(fn, mesh: Mesh, axis: str = "data"):
    """``run(params, batch)``: ``fn(params[i], rows)`` on every device of a
    1-D mesh (or every data shard of a mesh whose model axis has size 1),
    with ``batch`` split into equal parts of rows, each copied straight to
    its shard's device (without blocking, from pinned host memory);
    ``params[i]`` is shard i's copy on its device. Returns the outputs
    concatenated on the mesh's first device. Batch sizes must divide the
    data axis: callers pad."""
    devices = list(mesh.grid(axis)[:, 0])

    def run(params: Sequence, batch: torch.Tensor) -> torch.Tensor:
        rows = _split_rows(batch, len(devices))
        outs = run_shards([lambda i=i: fn(params[i], _to(rows[i], devices[i]))
                           for i in range(len(devices))], devices)
        return torch.cat([o.to(devices[0]) for o in outs])

    return run


def shard_batch_2d(fn, mesh: Mesh, data_axis: str = "data", model_axis: str = "model"):
    """``run(params, batch)`` over a (data, model) mesh: ``batch`` split on
    the data axis, ``fn(params[i][j], rows)`` on shard (i, j) with the
    model-axis partial sums of its forward joined by an :class:`AllReduce`
    of data group i (``models/vit.py::tp_psum_axis``); ``params[i][j]`` is
    model shard j's slice of the weights (``parallel/tp.py``) on that
    shard's device. Every shard of a group ends with the same output; rank
    0's are concatenated on the mesh's first device."""
    from cbas_tpu_torch.models.vit import tp_psum_axis

    grid = mesh.grid(data_axis, model_axis)
    n_data, n_model = grid.shape

    def run(params, batch: torch.Tensor) -> torch.Tensor:
        rows = _split_rows(batch, n_data)
        groups = [AllReduce(list(grid[i])) for i in range(n_data)]

        def shard(i, j):
            reduce = groups[i]
            with tp_psum_axis(lambda t: reduce(j, t)):
                return fn(params[i][j], _to(rows[i], grid[i][j]))

        fns = [lambda i=i, j=j: shard(i, j) for i in range(n_data) for j in range(n_model)]
        outs = run_shards(fns, list(grid.flat), [g.barrier for g in groups])
        return torch.cat([outs[i * n_model].to(grid[0][0]) for i in range(n_data)])

    return run
