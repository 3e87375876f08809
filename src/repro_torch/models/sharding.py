"""Logical-axis rules: one place that maps model axes onto mesh axes.

Model code names axes logically (``"batch"``, ``"heads"``, ``"cache_rows"``
...); :func:`use_rules` installs a rule set for a mesh, and
:func:`logical_to_spec` reads a tuple of logical names as the mesh axes each
one is split over: one entry per name, ``None`` (not split), a mesh axis
name, or a tuple of two or more (the entries of the reference's
``PartitionSpec``).
``serving.mesh_engine.ShardedEngine`` derives its row sharding from the
``"cache_rows"`` rule, so a rule overlay re-distributes the serving path
without touching its code.

The mesh :func:`use_rules` installs is a ``launch.mesh.Mesh`` (one host
process over its devices: ``ShardedEngine``'s rows) or a
``torch.distributed`` ``DeviceMesh`` (one process a device,
``launch.mesh.run_ranks``): a *process-group mesh*.  Under the latter the
model's tensors are DTensors, torch's counterpart of GSPMD:
:func:`placements` turns a spec into DTensor placements,
:func:`distribute` puts a full tensor on the mesh by its logical axes, and
:func:`constrain` (the reference's ``with_sharding_constraint``)
redistributes a DTensor.  While such a mesh is installed, plain tensors the
model makes (an ``arange``, a mask) act as replicated
(``implicit_replication``).  On a plain tensor :func:`constrain` is the
identity, so every single-device path and ``ShardedEngine``'s rows run
unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "DEFAULT_RULES",
    "NamedSharding",
    "use_rules",
    "logical_to_spec",
    "named_sharding",
    "current_mesh",
    "process_mesh",
    "placements",
    "distribute",
    "constrain",
    "shard_count",
    "shard_offset",
    "split_only",
    "is_spec",
    "distribute_tree",
    "divisible",
    "zeros",
]

MeshAxes = Union[None, str, Tuple[str, ...]]

# Production rules for the (pod, data, model) / (data, model) meshes: the
# reference's own (``src/repro/models/sharding.py``).  Parameter axes
# ("embed", "heads", "mlp", ...) and activation axes ("act_*") are distinct
# so FSDP-style weight sharding over the data axis never leaks onto
# activations.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "expert_cap": ("pod", "data"),  # MoE dispatch buffer token-capacity dim
    # caches
    "kv_seq": None,  # prefill cache seq axis
    "kv_seq_decode": "model",  # decode cache sharded along sequence (SP)
    "kv_heads": None,
    # batch-of-requests serving cache: one row per live session, rows split
    # across the data axis (ShardedEngine reads this rule)
    "cache_rows": ("pod", "data"),
    "head_dim": None,
    "state": None,
    # parameters
    "embed": "data",  # FSDP: weights gathered per layer
    "heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": None,  # expert counts (40/60) don't divide 16; TP via "mlp"
    "layers": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "conv": None,
    "frontend": None,
}


class NamedSharding(NamedTuple):
    """A mesh and the mesh axes of each tensor dimension (the reference's
    ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: Tuple[MeshAxes, ...]


_STATE: dict = {"mesh": None, "rules": None}


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Install (mesh, rules) — the defaults overlaid with ``rules`` — and
    restore the previous ones on exit.  Mesh axes the mesh lacks (``"pod"``
    on a one-pod mesh) are dropped from every rule."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    have = set(_axis_names(mesh))

    def _filt(v: MeshAxes) -> MeshAxes:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in have else None
        kept = tuple(a for a in v if a in have)
        return kept if kept else None

    rules = {k: _filt(v) for k, v in rules.items()}
    prev = dict(_STATE)
    _STATE.update(mesh=mesh, rules=rules)
    try:
        with implicit_replication() if isinstance(mesh, DeviceMesh) else contextlib.nullcontext():
            yield
    finally:
        _STATE.update(prev)


def current_mesh():
    return _STATE["mesh"]


def process_mesh() -> Optional[DeviceMesh]:
    """The installed mesh if it is a process-group ``DeviceMesh``, else None."""
    mesh = _STATE["mesh"]
    return mesh if isinstance(mesh, DeviceMesh) else None


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(_axis_names(mesh), (int(n) for n in mesh.mesh.shape))) if isinstance(mesh, DeviceMesh) \
        else dict(mesh.shape)


def logical_to_spec(logical: Sequence[Optional[str]]) -> Tuple[MeshAxes, ...]:
    """The mesh axes of each logical axis under the installed rules (all
    ``None`` outside :func:`use_rules`)."""
    rules = _STATE["rules"] or {}
    return tuple(_entry(None if name is None else rules.get(name)) for name in logical)


def _entry(axes: MeshAxes) -> MeshAxes:
    """One spec entry as ``PartitionSpec`` stores it: one axis as its name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def named_sharding(logical: Sequence[Optional[str]]) -> Optional[NamedSharding]:
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(logical))


def placements(spec: Sequence[MeshAxes], mesh) -> List:
    """DTensor placements of a spec (one entry a tensor dimension): for each
    mesh dimension, ``Shard(t)`` when dimension ``t``'s entry names that
    axis, alone or in a tuple, else ``Replicate()``.  A tuple splits one
    dimension over several mesh axes, the first the major one (JAX's order);
    DTensor splits it in mesh order, so a tuple out of mesh order raises."""
    names = _axis_names(mesh)
    out: List = [Replicate() for _ in names]
    for t, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {part} splits a dimension against the mesh's axis order {names}")
        for i in dims:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dimensions of spec {tuple(spec)}")
            out[i] = Shard(t)
    return out


def divisible(spec: Sequence[MeshAxes], shape: Sequence[int], mesh) -> List[MeshAxes]:
    """``spec`` with every entry whose shard count does not divide its
    dimension dropped (replicated), as the reference's ``constrain`` drops
    it: 15 attention heads on a 2-way axis stay whole."""
    sizes = _axis_sizes(mesh)
    out = list(spec)
    for i, part in enumerate(out):
        if part is None:
            continue
        total = 1
        for a in ((part,) if isinstance(part, str) else part):
            total *= sizes[a]
        if shape[i] % total:
            out[i] = None
    return out


def distribute(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """A full tensor ``x`` (the same on every rank) as a DTensor on the
    installed process-group mesh, placed by its logical axes (dropping
    those whose shard count does not divide); each rank keeps its block, no
    collective.  Without a process-group mesh ``x`` is returned as is."""
    mesh = process_mesh()
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"distribute got {len(logical)} axes for rank-{x.ndim} tensor")
    spec = divisible(logical_to_spec(logical), x.shape, mesh)
    return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)


def zeros(shape: Sequence[int], logical: Sequence[Optional[str]], *, dtype, device) -> torch.Tensor:
    """Zeros of ``shape``: under a process-group mesh a DTensor placed by its
    logical axes, each rank allocating only its block (on ``meta`` a block
    with no memory behind it: the dry run's caches); else a plain tensor."""
    mesh = process_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    place = placements(divisible(logical_to_spec(logical), shape, mesh), mesh)
    if torch.device(device).type != "meta":
        return dtensor_zeros(*shape, dtype=dtype, device_mesh=mesh, placements=place)
    local = list(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device="meta"), mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(shape, device="meta").stride())


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axis names: a DTensor is
    redistributed to the installed rules' placements (axes whose shard
    count does not divide the dimension dropped); a plain tensor, or any
    tensor outside :func:`use_rules`, is returned as is."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain got {len(logical)} axes for rank-{x.ndim} array")
    if not isinstance(x, DTensor):
        return x
    want = placements(divisible(logical_to_spec(logical), x.shape, mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def shard_count(x: DTensor, dim: int) -> int:
    """How many blocks DTensor ``x`` is split into along ``dim``."""
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            n *= x.device_mesh.size(i)
    return n


def shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's block of DTensor ``x`` starts along ``dim`` (even
    shards: every placement :func:`constrain` and :func:`distribute` make)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    index = 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            index = index * mesh.size(i) + coord[i]
    return index * (x.shape[dim] // shard_count(x, dim))


def split_only(x: DTensor, dim: int = 0) -> List:
    """``x``'s placements with every mesh axis that does not split ``dim``
    (by default the batch) replicated."""
    return [p if isinstance(p, Shard) and p.dim % x.ndim == dim else Replicate() for p in x.placements]


def is_spec(node) -> bool:
    """A spec tree's leaf: one tuple of logical axis names (or None)."""
    return isinstance(node, tuple) and all(a is None or isinstance(a, str) for a in node)


def distribute_tree(tree, specs):
    """Each tensor of ``tree`` placed by :func:`distribute` by the logical
    axes at its place in ``specs`` (``Model.param_specs()``, or a part)."""
    from repro_torch._tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [distribute(t, spec) for t, spec in
                                 zip(tree_leaves(tree), tree_leaves(specs, is_leaf=is_spec))])
