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

The reference's ``constrain`` (a sharding constraint on one tensor that
spans devices) has no counterpart here: the port's row sharding keeps each
shard's tensors whole on its own device, so nothing is constrained.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

__all__ = ["DEFAULT_RULES", "NamedSharding", "use_rules", "logical_to_spec", "named_sharding", "current_mesh"]

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
    have = set(mesh.axis_names)

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
        yield
    finally:
        _STATE.update(prev)


def current_mesh():
    return _STATE["mesh"]


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
