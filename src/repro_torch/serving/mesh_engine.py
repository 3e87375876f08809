"""Row-sharded serving engine: the batch-of-requests cache over a mesh.

One :class:`~repro_torch.serving.engine.Engine` binds the serving path to a
single device, so row capacity and stacked decode width stop at one card's
memory.  :class:`ShardedEngine` splits the batch-of-requests cache's *row*
axis over a mesh axis (blocked layout: global row ``r`` lives on shard
``r // (B/S)`` at local row ``r % (B/S)``) and runs the serving loop's row
primitives — run insertion (after the host-side
``codec.decode_chunk_runs``), coalesced TEXT recompute
(``prefill_extend_rows``), stacked generation (``decode_step_rows``) and
the row pool's save, reset and restore — on every shard's slice, on that
shard's device.  The row axis comes from the logical-axis rules
(``models.sharding.use_rules`` / ``logical_to_spec``, logical axis
``"cache_rows"``).

One host controller drives every shard; no process is started and no
collective runs.  Every primitive is row-parallel (each row attends over
its own prefix; the inactive-row merge, the window merge of run insertion,
save, restore and reset are row-local), so each shard runs exactly the
unsharded per-row arithmetic on its rows: a one-shard mesh is bit-identical
to the plain Engine, and a shard of ``B/S`` rows is bit-identical to the
plain Engine's same call on a cache of those ``B/S`` rows.  A different
batch may sum a product in another order, so against the plain Engine's
``B``-row call each request agrees within that rounding.

Calls are issued shard after shard.  Each primitive first moves every
shard's inputs to its device (without waiting for the device) and reads
every shard's lengths where the computation needs them on the host, then
launches each shard's work; no host read sits between two shards'
launches, so shards on distinct cards overlap.

Weights go to each distinct device of the mesh once; shards on one device
share them.  ``codec.decode_chunk_runs`` runs once, on the mesh's first
device (the codec tables' device), and each decoded run moves to the device
of the shard that owns its row.  Logits come back as one ``(B, T, V)``
tensor in global row order on the first device.

Caches.  :meth:`ShardedEngine.empty_caches` returns a
``kv_layout.ShardedCaches`` for a batch that divides into whole shards (the
schedulers size their pool cache through ``Engine.cache_rows``).  A batch
that does not divide — the batch-1 cache of a ``ServeSession`` or of
``CacheGenStreamer.materialize`` — comes back as a plain ``Caches`` on the
first device and is served by the inherited single-device methods: the
reference's own dispatch (``src/repro/serving/mesh_engine.py``), not a
fallback that hides a fault.  On a one-shard mesh every cache is plain and
the row primitives run it as the one shard.  ``calculate_kv``,
``decode_to_cache``, ``prefill_extend``, ``generate_with_kv`` and
``logits_with_kv`` take plain caches only; ``kv_layout.extract_row`` gives
one request's plain batch-1 view of a sharded cache, on its shard's device.

``kv_heads``-along-``model`` tensor parallelism inside a row is left out,
as in the reference: each shard runs on the first device of its slice of
the mesh, the other axes' devices idle (the reference replicates the shard
over them).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, sharding
from repro_torch.models.lm import Caches
from repro_torch.serving import kv_layout
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_layout import ShardedCaches

__all__ = ["ShardedEngine"]


class ShardedEngine(Engine):
    """Engine whose batch-of-requests cache rows are sharded over a mesh.

    ``mesh`` (``launch.mesh``) must carry the axis the ``"cache_rows"``
    rule maps to (the ``"data"`` axis of ``make_serving_mesh`` /
    ``make_test_mesh``); ``rules`` overlays the default logical-axis rule
    set.  ``device``, if given, must be of the mesh's device type; the
    engine's own device (plain caches, the codec's run decode, the logits)
    is the mesh's first.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        cache_capacity: int = 4096,
        *,
        mesh,
        rules: Optional[Dict[str, object]] = None,
        device=None,
    ):
        if cfg.family not in lm.ATTENTION_FAMILIES:
            raise ValueError(f"ShardedEngine needs a KV-cache attention family, got {cfg.family!r}")
        home = mesh.devices.flat[0]
        if device is not None and resolve_device(device).type != home.type:
            raise ValueError(f"device {device} is not of the mesh's device type {home.type!r}")
        super().__init__(cfg, tree_map(lambda t: t.to(home), params), cache_capacity, device=home)
        self.mesh = mesh
        # the partition specs come from the logical rule set, so re-mapping
        # "cache_rows" re-distributes the rows without touching this module
        with sharding.use_rules(mesh, rules):
            self._cache_spec = sharding.logical_to_spec(
                ("layers", "cache_rows", "kv_seq", "kv_heads", "head_dim")
            )
            self._rows_spec = sharding.logical_to_spec(("cache_rows",))
        part = self._rows_spec[0]
        axes = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
        if len(axes) > 1:
            raise ValueError(
                f"cache_rows maps to {axes} on this mesh; row sharding "
                f"supports exactly one mesh axis — overlay a rule like "
                f"{{'cache_rows': 'data'}}"
            )
        self.row_axis: Optional[str] = axes[0] if axes else None
        self.n_shards = int(mesh.shape[self.row_axis]) if self.row_axis else 1
        if self.row_axis is None:
            self.shard_devices: List[torch.device] = [home]
        else:
            by_row = np.moveaxis(mesh.devices, mesh.axis_names.index(self.row_axis), 0)
            self.shard_devices = list(by_row.reshape(self.n_shards, -1)[:, 0])
        # one plain Engine a distinct device, over that device's copy of the
        # weights: each shard's row program is that Engine's own
        self._engines: Dict[torch.device, Engine] = {home: Engine(cfg, self.params, cache_capacity, device=home)}
        for dev in self.shard_devices:
            if dev not in self._engines:
                self._engines[dev] = Engine(cfg, tree_map(lambda t: t.to(dev), self.params), cache_capacity,
                                            device=dev)

    # ------------------------------------------------------------------

    def empty_caches(self, batch: int):
        """A fresh batch-of-requests cache, row-sharded over the mesh.

        ``batch`` must divide into whole shards for the sharded layout (the
        schedulers round up through :meth:`cache_rows`); other batches, and
        every batch on a one-shard mesh, come back as a plain cache on the
        first device."""
        if self.n_shards == 1 or batch % self.n_shards:
            return super().empty_caches(batch)
        # a zero-row cache of the base class gives the dtype it allocates
        dtype = super().empty_caches(0).kv_k.dtype
        b = batch // self.n_shards
        return ShardedCaches(tuple(
            kv_layout.alloc_caches(self.cfg, b, self.capacity, dtype=dtype, device=dev)
            for dev in self.shard_devices
        ))

    def _shards(self, caches) -> Optional[ShardedCaches]:
        """The cache as shards, or None where the inherited single-device
        method serves it (a plain cache on a mesh of more than one shard)."""
        if isinstance(caches, ShardedCaches):
            return caches
        if self.n_shards == 1:
            return ShardedCaches((caches,))
        return None

    @staticmethod
    def _pack(caches, parts: Sequence[Caches]):
        return ShardedCaches(tuple(parts)) if isinstance(caches, ShardedCaches) else parts[0]

    def _gather_logits(self, logits: List[torch.Tensor]) -> torch.Tensor:
        if len(logits) == 1:
            return logits[0]
        return torch.cat([lg.to(self.device) for lg in logits])

    # ------------------------------------------------------------------
    # Row primitives, per shard
    # ------------------------------------------------------------------

    def insert_runs(self, caches, kv_new, rows: Sequence[int], starts: Sequence[int],
                    run_tokens: Sequence[int]):
        """Land several requests' decoded runs, each in its shard's rows,
        in place (``kv_layout.insert_codec_runs_local``); a shard's runs
        move to its device, and a shard no run addresses is left alone."""
        sh = self._shards(caches)
        if sh is None:
            return super().insert_runs(caches, kv_new, rows, starts, run_tokens)
        self._check_runs(kv_layout.cache_batch(sh), rows, starts, run_tokens)
        rows, starts, run_tokens = ([int(x) for x in xs] for xs in (rows, starts, run_tokens))
        kv_new = torch.as_tensor(kv_new, device=self.device)
        offs = np.concatenate([[0], np.cumsum(run_tokens)]).tolist()
        b = sh.rows_per_shard
        parts = []
        for s, (part, dev) in enumerate(zip(sh.shards, self.shard_devices)):
            mine = [i for i, r in enumerate(rows) if r // b == s]
            if not mine:
                parts.append(part)
                continue
            if len(mine) == len(rows):
                kv_s = kv_new
            else:
                kv_s = torch.cat([kv_new[:, :, offs[i]:offs[i + 1]] for i in mine], dim=2)
            # each run's window is placed exactly where the unsharded call
            # places it: insert_runs has checked every run fits the capacity
            k, v, ln = kv_layout.insert_codec_runs_local(
                part.kv_k, part.kv_v, part.length, kv_s.to(dev, non_blocking=True),
                [rows[i] for i in mine], [starts[i] for i in mine], [run_tokens[i] for i in mine], s,
            )
            parts.append(part._replace(kv_k=k, kv_v=v, length=ln))
        return self._pack(caches, parts)

    def save_row(self, caches, row: int, n_tokens: int) -> kv_layout.RowSnapshot:
        """Snapshot one row from the shard that owns it (on that shard's
        device)."""
        sh = self._shards(caches)
        if sh is None:
            return super().save_row(caches, row, n_tokens)
        self._check_save(kv_layout.cache_batch(sh), row, n_tokens)
        s, local = sh.locate(row)
        return kv_layout.save_row(sh.shards[s], local, int(n_tokens))

    def restore_row(self, caches, snapshot: kv_layout.RowSnapshot, row: int):
        """Write a snapshot into ``row``: the owning shard writes it (the
        snapshot moves to that shard's device, whichever shard saved it),
        the others write the addressed slot's own bytes back
        (``kv_layout.restore_row_local``)."""
        sh = self._shards(caches)
        if sh is None:
            return super().restore_row(caches, snapshot, row)
        self._check_restore(kv_layout.cache_batch(sh), snapshot, row)
        owner, _ = sh.locate(row)
        parts = []
        for s, (part, dev) in enumerate(zip(sh.shards, self.shard_devices)):
            k_row, v_row = snapshot.kv_k, snapshot.kv_v
            if s == owner:
                k_row, v_row = k_row.to(dev, non_blocking=True), v_row.to(dev, non_blocking=True)
            k, v, ln = kv_layout.restore_row_local(part.kv_k, part.kv_v, part.length, k_row, v_row, int(row), s)
            parts.append(part._replace(kv_k=k, kv_v=v, length=ln))
        return self._pack(caches, parts)

    def reset_rows(self, caches, rows: Sequence[int]):
        """Zero recycled rows, each on its own shard
        (``kv_layout.reset_rows_local``)."""
        sh = self._shards(caches)
        if sh is None:
            return super().reset_rows(caches, rows)
        self._check_rows("reset_rows", kv_layout.cache_batch(sh), rows)
        parts = []
        for s, part in enumerate(sh.shards):
            k, v, ln = kv_layout.reset_rows_local(part.kv_k, part.kv_v, part.length, rows, s)
            parts.append(part._replace(kv_k=k, kv_v=v, length=ln))
        return self._pack(caches, parts)

    def prefill_extend_rows(self, tokens, caches, widths) -> Tuple[torch.Tensor, object]:
        """Coalesced TEXT recompute: each shard runs the width-masked
        ``prefill_extend`` over its rows, with its rows of ``tokens`` and
        ``widths``."""
        sh = self._shards(caches)
        if sh is None:
            return super().prefill_extend_rows(tokens, caches, widths)
        self._check_extend()
        n_rows, b = kv_layout.cache_batch(sh), sh.rows_per_shard
        tokens = torch.as_tensor(tokens)
        widths = [int(w) for w in torch.as_tensor(widths).tolist()]
        if tokens.ndim != 2 or tokens.shape[0] != n_rows or len(widths) != n_rows:
            raise ValueError(
                f"prefill_extend_rows: tokens {tuple(tokens.shape)} and {len(widths)} widths "
                f"for a {n_rows}-row cache"
            )
        toks = [tokens[s * b:(s + 1) * b].to(dev, torch.long, non_blocking=True)
                for s, dev in enumerate(self.shard_devices)]
        starts = [part.length.tolist() for part in sh.shards]
        logits, parts = [], []
        for s, (part, dev) in enumerate(zip(sh.shards, self.shard_devices)):
            lg, new = lm.prefill_extend(self.cfg, self._engines[dev].params, toks[s], part,
                                        widths=widths[s * b:(s + 1) * b], starts=starts[s])
            logits.append(lg)
            parts.append(new)
        return self._gather_logits(logits), self._pack(caches, parts)

    def prefill_extend_gather(self, tokens, caches, rows) -> Tuple[torch.Tensor, object]:
        """Compact TEXT recompute for a few rows: the rows are gathered from
        their shards into one sub-batch on the first device, the base
        ``prefill_extend`` runs on it, and each row goes back to its shard
        (the reference's GSPMD gathers them alike)."""
        sh = self._shards(caches)
        if sh is None:
            return super().prefill_extend_gather(tokens, caches, rows)
        self._check_extend()
        self._check_rows("prefill_extend_gather", kv_layout.cache_batch(sh), rows)
        locs = [sh.locate(r) for r in rows]

        def gather(field, dim):
            return torch.cat([getattr(sh.shards[s], field).narrow(dim, i, 1).to(self.device) for s, i in locs],
                             dim=dim)

        sub = Caches(kv_k=gather("kv_k", 1), kv_v=gather("kv_v", 1), length=gather("length", 0))
        logits, sub = lm.prefill_extend(self.cfg, self.params, tokens, sub)
        lengths = [part.length.clone() for part in sh.shards]
        for j, (s, i) in enumerate(locs):
            part = sh.shards[s]
            part.kv_k[:, i] = sub.kv_k[:, j].to(part.kv_k.device, non_blocking=True)
            part.kv_v[:, i] = sub.kv_v[:, j].to(part.kv_v.device, non_blocking=True)
            lengths[s][i] = sub.length[j].to(lengths[s].device, non_blocking=True)
        return logits, self._pack(caches, [p._replace(length=ln) for p, ln in zip(sh.shards, lengths)])

    def decode_step_rows(self, tokens, caches, active) -> Tuple[torch.Tensor, object]:
        """Stacked generation step: each shard steps its rows (K3 once a
        layer a shard, at ``B/S`` rows), inactive rows bit-preserved
        (``Engine.decode_step_rows`` on the shard's device)."""
        sh = self._shards(caches)
        if sh is None:
            return super().decode_step_rows(tokens, caches, active)
        if self.cfg.family not in lm.ATTENTION_FAMILIES:
            raise ValueError(f"no cached generation for family {self.cfg.family}")
        n_rows, b = kv_layout.cache_batch(sh), sh.rows_per_shard
        tokens, active = torch.as_tensor(tokens), torch.as_tensor(active)
        self._check_step(n_rows, tokens, active)
        ins = [(tokens[s * b:(s + 1) * b].to(dev, torch.long, non_blocking=True),
                active[s * b:(s + 1) * b].to(dev, torch.bool, non_blocking=True))
               for s, dev in enumerate(self.shard_devices)]
        logits, parts = [], []
        for part, dev, (tok, act) in zip(sh.shards, self.shard_devices, ins):
            lg, new = self._engines[dev].decode_step_rows(tok, part, act)
            logits.append(lg)
            parts.append(new)
        return self._gather_logits(logits), self._pack(caches, parts)
