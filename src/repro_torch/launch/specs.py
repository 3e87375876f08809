"""Per-(arch x shape) dry-run cell definitions: meta inputs placed on a
process-group mesh, their logical shardings, and the step function to run.

Port of ``src/repro/launch/specs.py``.  The four assigned input shapes
(LM-family: seq_len x global_batch):
  train_4k     seq 4,096   batch 256   -> train_step
  prefill_32k  seq 32,768  batch 32    -> prefill
  decode_32k   seq 32,768  batch 128   -> serve_step (1 token + KV cache)
  long_500k    seq 524,288 batch 1     -> serve_step; sub-quadratic archs only

Family mapping (the reference's): enc-dec splits seq into src/tgt halves;
VLM reserves ``n_prefix_tokens`` of the sequence for the (stubbed) image
patch embeddings; SSM/hybrid decode cells carry recurrent states instead of
/ alongside KV caches.

Where the reference's cell holds ``ShapeDtypeStruct`` trees, a port cell
holds meta tensors (no memory behind them): parameters and AdamW moments
from :func:`~repro_torch.models.common.abstract_from_plan`, batches and
caches made on ``meta`` and each placed on the installed ``DeviceMesh`` by
its logical axes (``sharding.distribute`` / ``sharding.zeros``), so every
leaf but the caches' lengths is a DTensor whose local block is one rank's.
The lengths (``length``, ``src_len``) are plain tensors, whole on every
rank, as the port's model reads them; their logical spec is still the
reference's ``("batch",)``.  ``in_shardings`` and ``out_shardings`` hold the
reference's logical specs (``sharding.named_sharding``), before
``sharding.divisible`` drops the axes that do not divide a dimension.  The
reference's ``donate`` has no counterpart: the port's decode step writes
its caches in place and its train step makes a new state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import sharding
from repro_torch.models.common import DTYPES, Leaf, abstract_from_plan, specs_from_plan
from repro_torch.models.model import build as build_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.trainer import TrainState, make_train_step

__all__ = ["SHAPES", "Cell", "make_cell", "cell_applicable", "rules_for", "all_cells"]

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

_KV_LOGICAL = lm_lib.CACHE_AXES


def cell_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "full quadratic attention at 524K tokens — skipped per assignment "
            "(sub-quadratic archs only); see DESIGN.md §4"
        )
    return True, ""


@dataclasses.dataclass
class Cell:
    cfg: ArchConfig
    shape_name: str
    kind: str
    fn: Callable  # the step, called on the inputs
    inputs: Tuple[Any, ...]  # meta tensor trees (positional)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    rules: Dict[str, Any]  # logical rule overrides used


def _meta(shape, dtype, logical) -> torch.Tensor:
    """A meta tensor of ``shape`` placed by ``logical`` on the installed mesh."""
    return sharding.distribute(torch.zeros(shape, dtype=dtype, device="meta"), logical)


def _whole(shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------


def _batch_shapes(cfg: ArchConfig, seq: int, batch: int, train: bool) -> Dict[str, Tuple[tuple, torch.dtype]]:
    out: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if cfg.family == "encdec":
        s = seq // 2
        out["src_embeds"] = ((batch, s, cfg.frontend_dim), torch.bfloat16)
        out["tokens"] = ((batch, s), torch.int32)
        if train:
            out["labels"] = ((batch, s), torch.int32)
        return out
    if cfg.family == "vlm":
        t = seq - cfg.n_prefix_tokens
        out["patch_embeds"] = ((batch, cfg.n_prefix_tokens, cfg.frontend_dim), torch.bfloat16)
        out["tokens"] = ((batch, t), torch.int32)
        if train:
            out["labels"] = ((batch, t), torch.int32)
        return out
    out["tokens"] = ((batch, seq), torch.int32)
    if train:
        out["labels"] = ((batch, seq), torch.int32)
    return out


def _batch_logical(shape) -> tuple:
    return ("batch",) + (None,) * (len(shape) - 1)


def _batch_specs(cfg: ArchConfig, seq: int, batch: int, train: bool):
    """(meta batch, logical shardings)."""
    shapes = _batch_shapes(cfg, seq, batch, train)
    return ({k: _meta(s, dt, _batch_logical(s)) for k, (s, dt) in shapes.items()},
            {k: sharding.named_sharding(_batch_logical(s)) for k, (s, _) in shapes.items()})


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _cache(shape, dtype, logical) -> torch.Tensor:
    return sharding.zeros(shape, logical, dtype=dtype, device="meta")


def _lm_cache_specs(cfg: ArchConfig, batch: int, seq: int):
    """(meta caches, logical caches) for decode cells."""
    fields: Dict[str, Any] = dict(kv_k=None, kv_v=None, length=None, mamba_conv=None, mamba_ssm=None,
                                  shared_k=None, shared_v=None)
    log: Dict[str, Any] = dict(fields)
    if cfg.family in ("dense", "moe", "vlm"):
        shp = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
        for k in ("kv_k", "kv_v"):
            fields[k], log[k] = _cache(shp, torch.bfloat16, _KV_LOGICAL), _KV_LOGICAL
    if cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        log["mamba_conv"], log["mamba_ssm"] = lm_lib.CONV_AXES, lm_lib.SSM_AXES
        fields["mamba_conv"] = _cache((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch), torch.bfloat16,
                                      lm_lib.CONV_AXES)
        fields["mamba_ssm"] = _cache((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                                     torch.float32, lm_lib.SSM_AXES)
    if cfg.family == "hybrid":
        shp = (cfg.n_layers // cfg.shared_block_every, batch, seq, cfg.n_kv_heads, cfg.d_head)
        for k in ("shared_k", "shared_v"):
            fields[k], log[k] = _cache(shp, torch.bfloat16, _KV_LOGICAL), _KV_LOGICAL
    fields["length"], log["length"] = _whole((batch,), torch.int32), ("batch",)
    return lm_lib.Caches(**fields), lm_lib.Caches(
        **{k: (sharding.named_sharding(v) if v is not None else None) for k, v in log.items()})


def _encdec_cache_specs(cfg: ArchConfig, batch: int, seq: int):
    shp_self = (cfg.dec_layers, batch, seq // 2, cfg.n_kv_heads, cfg.d_head)
    shp_cross = (cfg.dec_layers, batch, seq // 2, cfg.n_kv_heads, cfg.d_head)
    caches = encdec_lib.EncDecCaches(
        self_k=_cache(shp_self, torch.bfloat16, _KV_LOGICAL),
        self_v=_cache(shp_self, torch.bfloat16, _KV_LOGICAL),
        cross_k=_cache(shp_cross, torch.bfloat16, _KV_LOGICAL),
        cross_v=_cache(shp_cross, torch.bfloat16, _KV_LOGICAL),
        src_len=_whole((batch,), torch.int32),
        length=_whole((batch,), torch.int32),
    )
    ns = sharding.named_sharding
    shardings = encdec_lib.EncDecCaches(
        self_k=ns(_KV_LOGICAL), self_v=ns(_KV_LOGICAL), cross_k=ns(_KV_LOGICAL), cross_v=ns(_KV_LOGICAL),
        src_len=ns(("batch",)), length=ns(("batch",)),
    )
    return caches, shardings


def _cache_specs(cfg: ArchConfig, batch: int, seq: int):
    if cfg.family == "encdec":
        return _encdec_cache_specs(cfg, batch, seq)
    return _lm_cache_specs(cfg, batch, seq)


# ---------------------------------------------------------------------------
# param/opt specs
# ---------------------------------------------------------------------------


def _plan(cfg: ArchConfig):
    return (encdec_lib if cfg.family == "encdec" else lm_lib).param_plan(cfg)


def _sharding_tree(plan):
    return {k: sharding.named_sharding(v.logical) if isinstance(v, Leaf) else _sharding_tree(v)
            for k, v in plan.items()}


def _param_specs(cfg: ArchConfig, dtype=None):
    """(meta parameters in ``dtype`` (the config's by default), logical shardings)."""
    plan = _plan(cfg)
    params = abstract_from_plan(plan, dtype or DTYPES[cfg.dtype])
    return sharding.distribute_tree(params, specs_from_plan(plan)), _sharding_tree(plan)


def _train_state_specs(cfg: ArchConfig):
    p, p_sh = _param_specs(cfg)
    moment = lambda: _param_specs(cfg, torch.float32)[0]  # noqa: E731
    state = TrainState(
        params=p,
        opt=opt_lib.OptState(mu=moment(), nu=moment(), step=_meta((), torch.int32, ())),
        ef_error=None,
        step=_meta((), torch.int32, ()),
    )
    rep = sharding.named_sharding(())
    state_sh = TrainState(params=p_sh, opt=opt_lib.OptState(mu=p_sh, nu=p_sh, step=rep), ef_error=None, step=rep)
    return state, state_sh


# ---------------------------------------------------------------------------
# rule overrides per cell
# ---------------------------------------------------------------------------


def rules_for(cfg: ArchConfig, shape_name: str) -> Dict[str, Any]:
    rules: Dict[str, Any] = {}
    if shape_name == "long_500k":
        # batch=1: nothing to shard on dp -> shard sequence/state instead
        rules["batch"] = None
        rules["expert_cap"] = None
        rules["kv_seq_decode"] = ("data", "model")
        rules["state"] = "data"
    if cfg.family == "encdec" and shape_name in ("decode_32k",):
        rules["kv_seq_decode"] = "model"
    return rules


# ---------------------------------------------------------------------------
# cell builder
# ---------------------------------------------------------------------------


def _all_meta(inputs) -> None:
    """Every input leaf lives on ``meta``: a full config's real tensors
    (222 GB of qwen1.5-110b weights, 1.37 TB of its decode caches) must
    never be allocated."""
    for leaf in tree_leaves(inputs):
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        if local.device.type != "meta":
            raise AssertionError(f"a dry-run cell input lives on {local.device}, not meta")


def make_cell(
    cfg: ArchConfig,
    shape_name: str,
    mesh,
    rule_overrides: Optional[Dict[str, Any]] = None,
) -> Cell:
    """The cell of ``cfg`` at ``shape_name`` on ``mesh``, a ``DeviceMesh`` of
    a started process group (a fake one for the dry run)."""
    info = SHAPES[shape_name]
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    rules = rules_for(cfg, shape_name)
    rules.update(rule_overrides or {})
    model = build_model(cfg)

    with sharding.use_rules(mesh, rules):
        if kind == "train":
            state, state_sh = _train_state_specs(cfg)
            b, b_sh = _batch_specs(cfg, seq, batch, train=True)
            rep = sharding.named_sharding(())
            metrics_sh = {k: rep for k in ("ce", "aux", "loss", "grad_norm", "lr")}
            cell = Cell(cfg=cfg, shape_name=shape_name, kind=kind, fn=make_train_step(model, opt_lib.AdamWConfig()),
                        inputs=(state, b), in_shardings=(state_sh, b_sh), out_shardings=(state_sh, metrics_sh),
                        rules=rules)
        elif kind == "prefill":
            p, p_sh = _param_specs(cfg)
            b, b_sh = _batch_specs(cfg, seq, batch, train=False)
            _, cache_sh = _cache_specs(cfg, batch, seq)
            logits_sh = sharding.named_sharding(("batch", None, "act_vocab"))

            def prefill_fn(params, b):
                return model.prefill(params, b)

            cell = Cell(cfg=cfg, shape_name=shape_name, kind=kind, fn=prefill_fn, inputs=(p, b),
                        in_shardings=(p_sh, b_sh), out_shardings=(logits_sh, cache_sh), rules=rules)
        else:  # decode
            p, p_sh = _param_specs(cfg)
            tok = _meta((batch, 1), torch.int32, ("batch", None))
            tok_sh = sharding.named_sharding(("batch", None))
            caches, cache_sh = _cache_specs(cfg, batch, seq)
            logits_sh = sharding.named_sharding(("batch", None, "act_vocab"))

            def decode_fn(params, tokens, caches):
                return model.decode_step(params, tokens, caches)

            cell = Cell(cfg=cfg, shape_name=shape_name, kind=kind, fn=decode_fn, inputs=(p, tok, caches),
                        in_shardings=(p_sh, tok_sh, cache_sh), out_shardings=(logits_sh, cache_sh), rules=rules)
    _all_meta(cell.inputs)
    return cell


def all_cells():
    from repro_torch.configs import registry

    for name in registry.names():
        cfg = registry.get(name)
        for shape_name in SHAPES:
            yield name, shape_name, cell_applicable(cfg, shape_name)
