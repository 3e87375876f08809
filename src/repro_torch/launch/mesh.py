"""Device meshes: named axes over CUDA cards, or logical shards of the host.

A :class:`Mesh` is an array of ``torch.device`` with one name per axis, the
reference's ``jax.sharding.Mesh`` without the runtime behind it.  One host
process drives every device of a mesh (``serving.mesh_engine.ShardedEngine``
splits its batch-of-requests cache's rows over the ``"data"`` axis), so
building a mesh starts no process and touches no device.  Its
``device_type``, ``mesh_shape`` and ``mesh_dim_names`` are the arguments of
``torch.distributed.device_mesh.init_device_mesh``, for code that runs one
process per device.

On the card a mesh takes the first ``n`` visible cards and raises a
``RuntimeError`` with the census and the remedy when there are fewer.  With
``device="cpu"`` it holds ``n`` logical shards of the host (the tests' mesh:
the counterpart of the reference's forced host device count).  A ``Mesh``
built directly may name one device more than once; two shards then share
that card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_production_mesh", "make_serving_mesh", "make_test_mesh"]

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
