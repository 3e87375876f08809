"""Collective traffic and FLOPs of one rank's step, seen as it runs.

Port of ``src/repro/launch/hlo_stats.py``.  The reference sums the result
sizes of every collective instruction in the optimized per-device HLO
(``cost_analysis()`` does not expose collective bytes).  The port has no
HLO: its programs run eagerly, on DTensors placed on a process-group mesh.
So :class:`CollectiveCounter`, a ``TorchDispatchMode``, records each
collective one rank issues as it runs, as a :class:`Record` of (kind,
result bytes, group size), and :func:`collective_stats` prices the records
as the reference prices its HLO lines.  An op on DTensors returns
``NotImplemented`` to the mode first, so DTensor desugars it into local ops
and the collectives of its redistributes before the mode sees them
(``CommDebugMode``'s trick), and the fake tensors of DTensor's shape
propagation are run uncounted: every count and byte is one rank's.

Ops recorded, by kind:
  all-gather          ``_c10d_functional.all_gather_into_tensor``,
                      ``c10d._allgather_base_``
  all-reduce          ``_c10d_functional.all_reduce``, ``c10d.allreduce_``
  reduce-scatter      ``_c10d_functional.reduce_scatter_tensor``,
                      ``c10d._reduce_scatter_base_``
  all-to-all          ``_c10d_functional.all_to_all_single``,
                      ``c10d.alltoall_base_``
``wait_tensor`` is skipped, as the reference skips ``-done(``: the
collective is counted where it starts.  The port issues no
collective-permute; the kind stays so that a record has the reference's
keys.

Wire-byte model (ring algorithms, group size n), the reference's:
  all-gather          result_bytes * (n-1)/n        (result = gathered)
  all-reduce          2 * result_bytes * (n-1)/n    (reduce-scatter + all-gather)
  reduce-scatter      result_bytes * (n-1)          (operand = result * n)
  all-to-all          result_bytes * (n-1)/n
  collective-permute  result_bytes
A record's group size is its process group's; :func:`collective_stats`
takes the mesh size for a record that has none.

:class:`FlopCounter` counts one rank's FLOPs the same way (DTensor ops
desugared first, each local op priced by ``torch.utils.flop_counter``'s
formulas), and adds itself to ``kernels.ops.FLOP_COUNTERS`` while entered,
so that each K3 and K4 call is counted by its plain version's product
FLOPs on every route (see ``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveStats", "collective_stats", "Record", "CollectiveCounter", "FlopCounter"]

_COLL_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


class Record(NamedTuple):
    """One collective as one rank issued it."""

    kind: str  # one of _COLL_KINDS
    result_bytes: int  # this rank's result
    group_size: Optional[int]  # ranks in its process group (None: the mesh)


def _ops():
    """op overload packet -> (kind, where its group is among the args)."""
    f, c = torch.ops._c10d_functional, torch.ops.c10d
    return {
        f.all_gather_into_tensor: ("all-gather", "name"),
        f.all_reduce: ("all-reduce", "name"),
        f.reduce_scatter_tensor: ("reduce-scatter", "name"),
        f.all_to_all_single: ("all-to-all", "name"),
        c._allgather_base_: ("all-gather", "object"),
        c.allreduce_: ("all-reduce", "object"),
        c._reduce_scatter_base_: ("reduce-scatter", "object"),
        c.alltoall_base_: ("all-to-all", "object"),
    }


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _group_size(args, how: str) -> Optional[int]:
    """The size of the process group a collective runs over: the functional
    ops name it by their last string argument, the c10d ops pass it."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    if how == "name":
        names = [a for a in args if isinstance(a, str)]
        return _resolve_process_group(names[-1]).size() if names else None
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return torch.distributed.ProcessGroup.unbox(a).size()
    return None


def _result(func, args, out):
    """The tensor(s) a collective leaves its result in: the functional ops
    return it; the c10d ops write into their first argument (the output
    tensor, or the list of tensors reduced in place)."""
    return args[0] if func._overloadpacket._qualified_op_name.startswith("c10d::") else out


def _desugar(types) -> bool:
    """Whether an op is not one rank's own: an op on DTensors (left to
    DTensor, which runs it as local ops and collectives) or on fake tensors
    (DTensor's propagation of global shapes, which runs no computation)."""
    return any(issubclass(t, (DTensor, FakeTensor)) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """While entered, ``records`` gets one :class:`Record` a collective that
    this rank issues (see the module docstring for the ops)."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []
        self._ops = _ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _desugar(types):
            return out
        hit = self._ops.get(getattr(func, "_overloadpacket", None))
        if hit is not None:
            kind, how = hit
            self.records.append(Record(kind, _nbytes(_result(func, args, out)), _group_size(args, how)))
        return out


class FlopCounter(TorchDispatchMode):
    """While entered, ``flops`` adds up the FLOPs of the local ops this rank
    runs (``torch.utils.flop_counter``'s formulas: two a multiply-add), and
    K3 and K4 calls add their plain version's product FLOPs
    (``kernels.ops.attention_flops``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flops = 0
        self._registry = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _desugar(types):
            return out
        fn = self._registry.get(getattr(func, "_overloadpacket", None))
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        return out

    def __enter__(self):
        from repro_torch.kernels import ops

        ops.FLOP_COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.FLOP_COUNTERS.remove(self)
        return super().__exit__(*exc)


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]  # per-device result bytes per kind
    wire_bytes: Dict[str, float]  # modeled per-device wire bytes per kind

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_result_bytes(self) -> int:
        return int(sum(self.result_bytes.values()))


def collective_stats(records: Iterable[Record], mesh_size: int) -> CollectiveStats:
    """Counts, result bytes and ring-model wire bytes by kind (module
    docstring) of one rank's collective records."""
    counts = {k: 0 for k in _COLL_KINDS}
    rbytes = {k: 0 for k in _COLL_KINDS}
    wbytes = {k: 0.0 for k in _COLL_KINDS}
    for kind, b, n in records:
        n = mesh_size if n is None else n
        counts[kind] += 1
        rbytes[kind] += b
        if kind == "all-reduce":
            w = 2.0 * b * (n - 1) / max(n, 1)
        elif kind == "all-gather":
            w = b * (n - 1) / max(n, 1)
        elif kind == "reduce-scatter":
            w = float(b) * (n - 1)
        elif kind == "all-to-all":
            w = b * (n - 1) / max(n, 1)
        else:  # collective-permute
            w = float(b)
        wbytes[kind] += w
    return CollectiveStats(counts=counts, result_bytes=rbytes, wire_bytes=wbytes)
