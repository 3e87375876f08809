"""Device meshes: named axes over CUDA cards, or logical shards of the host.

A :class:`Mesh` is an array of ``torch.device`` with one name per axis, the
reference's ``jax.sharding.Mesh`` without the runtime behind it.  It serves
two ways of running on several devices:

* one host process drives every device (``serving.mesh_engine.
  ShardedEngine`` splits its batch-of-requests cache's rows over the
  ``"data"`` axis); building a mesh starts no process and touches no
  device;
* one process a device on ``torch.distributed`` (the reference's collectives
  and its GSPMD model under ``sharding.use_rules``): :func:`run_ranks`
  spawns ``mesh.devices.size`` ranks, rank ``r`` on ``mesh.devices.flat[r]``,
  and hands each a ``torch.distributed.device_mesh.DeviceMesh`` of the
  mesh's shape and axis names (:func:`init_rank`).  Install that
  ``DeviceMesh`` with ``sharding.use_rules`` and the model's tensors become
  DTensors placed by the rules.

The backend follows the devices (:func:`backend_for`): ``gloo`` on the CPU,
``nccl`` when each rank has a card of its own, and ``gloo`` when ranks share
a card, since NCCL refuses two ranks on one device ("Duplicate GPU
detected").  On CUDA tensors gloo runs every collective the port issues but
one: the functional ``all_gather_into_tensor`` behind DTensor's
``Shard -> Replicate`` crashes the process (a segmentation fault, torch
2.11 on the H100), so a gloo group on cards stages that one collective
through pinned host memory (:func:`stage_all_gather`; its bytes are counted
in :data:`STAGED`).

On the card a mesh takes the first ``n`` visible cards and raises a
``RuntimeError`` with the census and the remedy when there are fewer.  With
``device="cpu"`` it holds ``n`` logical shards of the host (the tests' mesh:
the counterpart of the reference's forced host device count).  A ``Mesh``
built directly may name one device more than once; two shards then share
that card.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_serving_mesh",
    "make_test_mesh",
    "backend_for",
    "init_rank",
    "device_mesh",
    "run_ranks",
    "all_gather_into_tensor",
    "STAGED",
]

DeviceLike = Union[str, torch.device]


class Mesh:
    """Named axes over an array of devices (one device type)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        seq = np.asarray(devices, dtype=object)
        arr = np.empty(seq.shape, dtype=object)
        for idx, d in np.ndenumerate(seq):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names {axis_names} repeat")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in arr.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got {sorted(types)}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (the reference's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return tuple(int(n) for n in self.devices.shape)

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def _census() -> str:
    """The visible cards, for error messages: ``2 visible (2x cuda: NAME)``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    kinds: Dict[str, int] = {}
    for i in range(n):
        name = torch.cuda.get_device_name(i)
        kinds[name] = kinds.get(name, 0) + 1
    census = ", ".join(f"{c}x cuda: {name}" for name, c in sorted(kinds.items())) or "no CUDA device"
    return f"{n} visible ({census})"


def _require_devices(n: int, shape: Tuple[int, ...], axes: Sequence[str],
                     device: Optional[DeviceLike]) -> list:
    """The first ``n`` cards, ``n`` logical shards of the host for
    ``device="cpu"``, or a RuntimeError naming the census and the remedy."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev is not None and dev.type != "cuda":
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {tuple(shape)} with axes {tuple(axes)}, have {_census()}. "
            f"Remediation: make {n} cards visible to this process (CUDA_VISIBLE_DEVICES lists the cards it "
            f"may use), or pass device='cpu' for {n} logical shards of the host"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = _require_devices(int(np.prod(shape)), shape, axes, None)
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axes)


def make_test_mesh(data: int = 2, model: int = 2, device: Optional[DeviceLike] = None) -> Mesh:
    """A small ``("data", "model")`` mesh."""
    devices = _require_devices(data * model, (data, model), ("data", "model"), device)
    return Mesh(np.asarray(devices, dtype=object).reshape(data, model), ("data", "model"))


def make_serving_mesh(data: int, device: Optional[DeviceLike] = None) -> Mesh:
    """One-axis ``("data",)`` mesh of ``data`` devices for row-sharded
    serving: ``ShardedEngine`` splits its batch-of-requests cache's rows
    over it (one shard of rows, one Transport, one contention domain per
    device)."""
    if data < 1:
        raise ValueError(f"make_serving_mesh needs data >= 1, got {data}")
    devices = _require_devices(data, (data,), ("data",), device)
    return Mesh(devices, ("data",))


# ---------------------------------------------------------------------------
# One process a device on torch.distributed
# ---------------------------------------------------------------------------

# bytes a gloo group on cards moved through pinned host memory in this
# process (:func:`all_gather_into_tensor`): the input sent and the gathered
# output received, each counted once
STAGED = {"calls": 0, "bytes": 0}


def backend_for(mesh: Mesh) -> str:
    """The process-group backend for one rank a device of ``mesh``: ``gloo``
    on the CPU; ``nccl`` when every rank has a card of its own; ``gloo`` when
    ranks share a card (NCCL refuses two ranks on one device)."""
    if mesh.device_type == "cpu":
        return "gloo"
    if mesh.device_type != "cuda":
        raise ValueError(f"no process-group backend for {mesh.device_type}")
    devices = list(mesh.devices.flat)
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def _staged(group) -> bool:
    """Whether collectives of ``group`` on CUDA tensors go through host memory."""
    return dist.get_backend(group) == "gloo"


def all_gather_into_tensor(out: torch.Tensor, inp: torch.Tensor, group=None) -> torch.Tensor:
    """``torch.distributed.all_gather_into_tensor`` into ``out`` (the ranks'
    ``inp`` stacked on dim 0).  On a gloo group with CUDA tensors the input
    goes to pinned host memory, the gather runs there and the result comes
    back into ``out`` on the card (:data:`STAGED` counts the bytes); every
    other case is the plain collective."""
    if inp.device.type != "cuda" or not _staged(group):
        dist.all_gather_into_tensor(out, inp, group=group)
        return out
    host_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host_in.copy_(inp)
    dist.all_gather_into_tensor(host_out, host_in, group=group)
    out.copy_(host_out)
    STAGED["calls"] += 1
    STAGED["bytes"] += host_in.numel() * host_in.element_size() + host_out.numel() * host_out.element_size()
    return out


def stage_all_gather(input: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    """The functional ``all_gather_into_tensor`` (what DTensor issues for
    ``Shard -> Replicate``) through :func:`all_gather_into_tensor`."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    out = input.new_empty((input.shape[0] * group_size,) + tuple(input.shape[1:]))
    return all_gather_into_tensor(out, input.contiguous(), _resolve_process_group(group_name))


_STAGING_LIBS: List[Any] = []  # keeps the registration alive for the process


def _install_staging() -> None:
    """Route CUDA calls of ``_c10d_functional::all_gather_into_tensor`` in this
    process through :func:`stage_all_gather` (a rank of a gloo group on cards)."""
    if _STAGING_LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", stage_all_gather, "CUDA")
    _STAGING_LIBS.append(lib)


def init_rank(mesh: Mesh, rank: int, init_file: str, *, timeout_s: float = 600.0):
    """Join rank ``rank`` of a process group of ``mesh.devices.size`` ranks
    (initialised through the ``file://`` store ``init_file``, no TCP port)
    and return the ``DeviceMesh`` of ``mesh``'s shape and axis names.  Rank
    ``r`` runs on ``mesh.devices.flat[r]`` (a card named without an index:
    the process's current one); a CPU rank uses one thread."""
    n = int(mesh.devices.size)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} devices")
    device = mesh.devices.flat[rank]
    backend = backend_for(mesh)
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None else torch.cuda.current_device())
        if backend == "gloo":
            _install_staging()
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device_mesh(mesh)


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` of ``mesh`` in a started process group, whose world
    size must be the mesh's device count."""
    from torch.distributed.device_mesh import init_device_mesh

    n = int(mesh.devices.size)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a process group of {world} ranks cannot hold mesh {mesh.shape} of {n} devices")
    return init_device_mesh(mesh.device_type, mesh.mesh_shape, mesh_dim_names=mesh.mesh_dim_names)


def _rank_main(rank: int, fn: Callable, mesh: Mesh, init_file: str, out_dir: str, args: tuple,
               timeout_s: float) -> None:
    dm = init_rank(mesh, rank, init_file, timeout_s=timeout_s)
    try:
        result = fn(rank, dm, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, mesh: Mesh, args: tuple = (), *, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, device_mesh, *args)`` in one spawned process a device
    of ``mesh`` and return each rank's result, rank by rank (``fn`` must be
    importable by name and return what ``torch.save`` stores: keep tensors
    on the CPU).  A rank that raises ends the others and raises here; a
    collective that waits longer than ``timeout_s`` fails its rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, mesh, os.path.join(tmp, "store"), tmp, tuple(args), timeout_s),
                           nprocs=int(mesh.devices.size), join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(int(mesh.devices.size))]
