"""Fault-tolerant checkpointing: atomic, versioned, in the reference's format.

Port of ``src/repro/checkpoint/manager.py``, with its protocol and its
on-disk format, so each package restores the other's directories:

  1. serialize the tree into ``step_<N:010d>.tmp-<nonce>/``: one ``.npy`` a
     leaf, named by its key path (``/`` -> ``__``), and ``metadata.json``
     with the step and each leaf's file, dtype name and shape;
  2. fsync the files, then atomically ``rename`` the directory to
     ``step_<N:010d>``;
  3. update ``LATEST`` by write-temp + rename.
Restore never sees a partial checkpoint: only renamed directories count.
Retention keeps the newest ``keep`` checkpoints.

Key paths and leaf order are the reference's (``repro_torch._tree``): a
``TrainState`` stores ``.params/embed``, ``.opt/.mu/layers/attn/wq``, ...,
``.step``, and a ``None`` field (``ef_error`` without compression) stores
nothing.  bf16 (and fp8) leaves are stored as the raw ``uint8`` bytes of
the tensor with the logical dtype in the manifest, as the reference stores
its ``ml_dtypes`` arrays, and read back by viewing those bytes as the
torch dtype: no ``ml_dtypes`` and no numpy bf16 dtype is needed.

``restore`` casts each leaf to the target leaf's dtype and device; with
``shardings`` (a tree of ``sharding.NamedSharding`` over a process-group
``DeviceMesh``, as ``sharding.named_sharding`` gives) each leaf is put on
that mesh as a DTensor of the spec's placements, each rank keeping its
block: how a job resumes on another topology.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_unflatten

__all__ = ["CheckpointManager"]

_SEP = "/"

# dtypes numpy cannot hold natively: stored as raw byte views, named in the manifest
_EXOTIC = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_storable(t: torch.Tensor):
    """(numpy array to write, logical dtype name) of one leaf."""
    t = t.detach()
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXOTIC:
        return t.contiguous().view(torch.uint8).cpu().numpy(), name
    return t.cpu().numpy(), name


def _from_storable(arr: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype_name in _EXOTIC:
        t = t.view(_EXOTIC[dtype_name])
    return t.reshape(shape)


def _keyed(tree) -> List:
    return [(_SEP.join(path), leaf) for path, leaf in tree_flatten_with_path(tree)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Dict[str, Any]] = {}
        for key, leaf in _keyed(tree):
            fname = key.replace(_SEP, "__") + ".npy"
            storable, dtype_name = _to_storable(leaf)
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, storable)
                f.flush()
                os.fsync(f.fileno())
            manifest[key] = {"file": fname, "dtype": dtype_name, "shape": list(leaf.shape)}
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)  # atomic publish
        self._update_latest(final)
        self._gc()
        return final

    def _update_latest(self, final: str) -> None:
        latest = os.path.join(self.dir, "LATEST")
        tmp = latest + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, latest)

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.isdir(os.path.join(self.dir, name)):
                return int(name[5:])
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``target_like``: each leaf cast to
        the matching target leaf's dtype and device; a shape that differs
        from the target's raises.  ``shardings``: an optional tree of the
        same structure holding a ``sharding.NamedSharding`` a leaf; each
        leaf becomes a DTensor on that sharding's mesh, placed by its spec
        (cross-topology resume)."""
        from repro_torch.models.sharding import NamedSharding, placements

        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        keyed = _keyed(target_like)
        where = None
        if shardings is not None:
            where = tree_leaves(shardings, is_leaf=lambda n: isinstance(n, NamedSharding))
            if len(where) != len(keyed):
                raise ValueError(f"shardings hold {len(where)} leaves for a tree of {len(keyed)}")
        leaves = []
        for i, (key, like) in enumerate(keyed):
            info = meta["leaves"][key]
            t = _from_storable(np.load(os.path.join(path, info["file"])), info["dtype"], info["shape"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs {tuple(like.shape)}")
            t = t.to(device=like.device, dtype=like.dtype)
            if where is not None:
                from torch.distributed.tensor import distribute_tensor

                ns = where[i]
                t = distribute_tensor(t, ns.mesh, placements(ns.spec, ns.mesh), src_data_rank=None)
            leaves.append(t)
        return tree_unflatten(target_like, leaves)
