"""Spawned ``torch.distributed`` groups for the port's distributed tests
(``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_train.py``).

Each test file spawns one 4-rank gloo group on ``make_test_mesh(2, 2,
device="cpu")`` (``launch.mesh.run_ranks``) and runs all of its scenarios
in it.  The test process writes the inputs (the reference's weights,
caches and batches as numpy arrays, which each rank converts with
``params_from_numpy``) to ``tmp_path``; rank 0 writes the scenarios'
results there (full tensors: ``full_tensor()`` of every DTensor), and each
rank returns what only it can show (its local blocks).  This module
imports no JAX: the ranks run the port alone.
"""
import dataclasses
import os

import torch
from torch.distributed.tensor import Shard

from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_unflatten
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.models import build, lm, moe, sharding
from repro_torch.models.common import specs_from_plan
from repro_torch.models.convert import params_from_numpy

INPUTS, RESULTS = "inputs.pt", "results.pt"
DECODE_ARCH = "olmo-1b"
MOE_ARCH = "qwen2-moe-a2.7b"
SP_RULES = {"embed": None, "kv_seq_decode": "model"}
TRAIN_RULES = {"embed": None}
# a tuple entry: the vocab split four ways over ("data", "model")
RESTORE_RULES = {"embed": None, "vocab": ("data", "model")}


def spawn(fn, tmp_path, inputs):
    """Write ``inputs`` to ``tmp_path``, run ``fn(rank, device_mesh,
    directory)`` on the 2 x 2 gloo group, and return (rank 0's results
    from ``tmp_path``, every rank's return value)."""
    torch.save(inputs, os.path.join(tmp_path, INPUTS))
    per_rank = run_ranks(fn, make_test_mesh(2, 2, device="cpu"), (str(tmp_path),), timeout_s=120.0)
    return torch.load(os.path.join(tmp_path, RESULTS), weights_only=False), per_rank


def _load(directory):
    return torch.load(os.path.join(directory, INPUTS), weights_only=False)


def _save(directory, rank, results):
    if rank == 0:
        torch.save(results, os.path.join(directory, RESULTS))


def full(x):
    """A DTensor's full value on the CPU (a plain tensor as it is)."""
    return (x.full_tensor() if isinstance(x, torch.distributed.tensor.DTensor) else x).detach().cpu()


def placed(x) -> tuple:
    """A DTensor's placements as names: ``("Shard(1)", "Replicate")``."""
    return tuple(f"Shard({p.dim})" if isinstance(p, Shard) else type(p).__name__ for p in x.placements)


def dcfg(arch, dtype, **kw):
    return dataclasses.replace(registry.get(arch).tiny(), dtype=dtype, **kw)


def _train_step(dm, cfg, t, grads=True):
    """One train step of ``cfg`` from the reference's state ``t`` under
    ``TRAIN_RULES``: the state after it, the metrics, the parameters'
    placements and (with ``grads``) the gradients at ``t`` from
    ``loss_and_grads``, full tensors."""
    from repro_torch.training import AdamWConfig
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.trainer import TrainState, distribute_state, loss_and_grads, make_train_step

    model = build(cfg)
    params = params_from_numpy(cfg, t["params"], "cpu")
    zeros = lambda tree: tree_unflatten(tree, [torch.zeros_like(x) for x in tree_leaves(tree)])  # noqa: E731
    state = TrainState(params=params, opt=OptState(mu=zeros(params), nu=zeros(params),
                                                   step=torch.zeros((), dtype=torch.int32)),
                       ef_error=None, step=torch.zeros((), dtype=torch.int32))
    batch = {k: torch.as_tensor(v) for k, v in t["batch"].items()}
    out = {}
    with sharding.use_rules(dm, TRAIN_RULES):
        ds = distribute_state(model, state)
        out["param_placements"] = {"/".join(k): placed(v) for k, v in tree_flatten_with_path(ds.params)}
        if grads:
            _, _, g = loss_and_grads(model, ds.params, {k: sharding.distribute(v, ("batch", "seq"))
                                                        for k, v in batch.items()})
            out["grads"] = [full(x) for x in tree_leaves(g)]
        s1, metrics = make_train_step(model, AdamWConfig(**t["opt"]))(ds, batch)
        out["state"] = {"p": [full(x) for x in tree_leaves(s1.params)],
                        "mu": [full(x) for x in tree_leaves(s1.opt.mu)],
                        "nu": [full(x) for x in tree_leaves(s1.opt.nu)]}
        out["metrics"] = {k: float(full(v)) for k, v in metrics.items()}
        out["step"] = int(full(s1.step))
    return out, state, model


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py: decode, MoE (its train step too), compressed_psum
# ---------------------------------------------------------------------------


def _decode_case(dm, case):
    """Prefill and one decode step of ``case`` (the reference's weights,
    tokens, caches and lengths) under the rules."""
    cfg = dcfg(DECODE_ARCH, case["dtype"])
    params = params_from_numpy(cfg, case["params"], "cpu")
    specs = lm.param_specs(cfg)
    out = {}
    with sharding.use_rules(dm, SP_RULES):
        dp = sharding.distribute_tree(params, specs)
        logits, caches = lm.prefill(cfg, dp, {"tokens": torch.as_tensor(case["tokens"])}, pad_to=case["cap"])
        out["prefill_logits"], out["prefill_k"], out["prefill_v"] = (full(t) for t in (logits, caches.kv_k,
                                                                                         caches.kv_v))
        out["placements"] = placed(caches.kv_k)
        ref = lm.Caches(kv_k=sharding.distribute(torch.as_tensor(case["kv_k"]).to(params["embed"].dtype),
                                                 lm.CACHE_AXES),
                        kv_v=sharding.distribute(torch.as_tensor(case["kv_v"]).to(params["embed"].dtype),
                                                 lm.CACHE_AXES),
                        length=torch.as_tensor(case["length"]))
        logits, caches = lm.decode_step(cfg, dp, torch.as_tensor(case["tok"]), ref)
        out["sp_logits"], out["sp_k"], out["sp_v"] = (full(t) for t in (logits, caches.kv_k, caches.kv_v))
        out["length"] = caches.length.clone()
    return out


def serve_scenarios(rank, dm, directory):
    inputs = _load(directory)
    results, mine = {}, {}
    for name, case in inputs["decode"].items():
        results[f"decode_{name}"] = _decode_case(dm, case)
    # decode on a process-group mesh with no kv_seq_decode axis: each rank's rows whole
    case = inputs["decode"]["f32"]
    cfg = dcfg(DECODE_ARCH, "float32")
    params = params_from_numpy(cfg, case["params"], "cpu")
    with sharding.use_rules(dm, {"embed": None, "kv_seq_decode": None}):
        dp = sharding.distribute_tree(params, lm.param_specs(cfg))
        caches = lm.Caches(kv_k=sharding.distribute(torch.as_tensor(case["kv_k"]), lm.CACHE_AXES),
                           kv_v=sharding.distribute(torch.as_tensor(case["kv_v"]), lm.CACHE_AXES),
                           length=torch.as_tensor(case["length"]))
        logits, caches = lm.decode_step(cfg, dp, torch.as_tensor(case["tok"]), caches)
        results["rows_logits"], results["rows_k"] = full(logits), full(caches.kv_k)
        results["rows_placements"] = placed(caches.kv_k)
    # the grouped (and global) MoE layer: its sharded combine
    for name, case in inputs["moe"].items():
        cfg = dcfg(MOE_ARCH, "float32", **case["cfg"])
        p = params_from_numpy(cfg, case["params"], "cpu")["layers"]["moe"]
        p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
        x = torch.as_tensor(case["x"])
        with sharding.use_rules(dm, {"embed": None}):
            dp = sharding.distribute_tree(p, specs_from_plan(moe.moe_plan(cfg)))
            xd = sharding.distribute(x, ("batch", "seq", "act_embed"))
            out, aux = moe.moe_apply(cfg, dp, xd)
            G, _ = moe._groups(cfg, x.shape[0] * x.shape[1])
            xg = sharding.constrain(xd.reshape(G, -1, cfg.d_model), "expert_cap", None, "act_embed")
            results[f"moe_{name}"] = {"out": full(out), "aux": float(full(aux)),
                                      "groups": (G, moe._local_groups(xg)[0].to_local().shape[0]),
                                      "drops": int(moe.dropped_slots(cfg, dp, xd)),
                                      "drops_one": int(moe.dropped_slots(cfg, p, x))}
    # the grouped MoE under autograd: one train step through its sharded
    # combine's backward (the step's gradients are read off its first moments)
    results["moe_train"], _, _ = _train_step(dm, dcfg(MOE_ARCH, "float32", moe_dispatch="grouped"),
                                             inputs["moe_train"], grads=False)
    # constrain on DTensors: 15 heads stay whole on the 2-way model axis, 16 split
    with sharding.use_rules(dm, {"embed": None}):
        got = {}
        for h in (15, 16):
            x = torch.arange(2 * 4 * h * 8, dtype=torch.float32).reshape(2, 4, h, 8)
            xd = sharding.distribute(x, ("batch", None, None, None))
            c = sharding.constrain(xd, "batch", "seq", "act_heads", "head_dim")
            got[f"heads{h}"] = placed(c)
            got.setdefault("values", True)
            got["values"] &= torch.equal(full(c), x)
            got["same"] = sharding.constrain(c, "batch", "seq", "act_heads", "head_dim") is c
        results["constrain"] = got
    # the staged gather's arithmetic (CPU tensors take the plain collective)
    import torch.distributed as dist

    from repro_torch.launch.mesh import stage_all_gather

    group = dm.get_group("data")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    results["staged"] = stage_all_gather(x, 2, group.group_name)
    results["staged_want"] = torch.empty(4, 3)
    dist.all_gather_into_tensor(results["staged_want"], x, group=group)
    # compressed_psum over "data": this rank's own tensor
    from repro_torch.training.grad_compress import _int8_symbols, compressed_psum

    x = torch.as_tensor(inputs["psum"][rank])
    with sharding.use_rules(dm):
        mine["psum"] = compressed_psum(x, "data")
        mine["psum_q"], mine["psum_scale"] = _int8_symbols(x, dm.get_group("data"))
        mine["psum_bf16"] = compressed_psum(x.to(torch.bfloat16), "data")
    mine["coord"] = tuple(dm.get_coordinate())
    _save(directory, rank, results)
    return mine


# ---------------------------------------------------------------------------
# tests/test_torch_distributed_train.py: the train step and sharded restore
# ---------------------------------------------------------------------------


def train_scenarios(rank, dm, directory):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.trainer import TrainState

    inputs = _load(directory)
    mine = {}
    results, state, model = _train_step(dm, dcfg(DECODE_ARCH, "float32"), inputs["train"])
    params = state.params
    # the reference's checkpoint restored onto the mesh
    ck = inputs["restore"]
    with sharding.use_rules(dm, RESTORE_RULES):
        ns = lambda spec: sharding.named_sharding(spec)  # noqa: E731
        pspecs = tree_unflatten(params, [ns(s) for s in tree_leaves(model.param_specs(), is_leaf=sharding.is_spec)])
        shardings = TrainState(params=pspecs, opt=OptState(mu=pspecs, nu=pspecs, step=ns(())),
                               ef_error=None, step=ns(()))
        restored = CheckpointManager(ck["dir"]).restore(ck["step"], state, shardings=shardings)
        flat = tree_flatten_with_path(restored)
        mine["local"] = {"/".join(k): v.to_local().clone() for k, v in flat}
        mine["spec"] = {"/".join(k): s.spec for (k, _), s in
                        zip(flat, tree_leaves(shardings, is_leaf=lambda n: isinstance(n, sharding.NamedSharding)))}
        results["restored"] = {"/".join(k): full(v) for k, v in flat}
    mine["coord"] = tuple(dm.get_coordinate())
    _save(directory, rank, results)
    return mine


# ---------------------------------------------------------------------------
# tests/test_torch_distributed_card.py: ranks on the card
# ---------------------------------------------------------------------------


def card_scenarios(rank, dm, directory):
    """On the card (no JAX anywhere): the SP decode of smollm-360m
    ``.tiny()`` in bf16 against the single-process K3 decode, one sharded
    train step (K4 through ``local_map`` under autograd) against the
    single-process step (the loss, and ``chip_smoke.step_agreement`` of
    its moments and update, and of a step that changes nothing), the f32
    gradients of qwen2-moe-a2.7b ``.tiny()``'s grouped dispatch (the
    sharded combine under autograd) against the single process's, and
    ``compressed_psum`` of this rank's tensor over ``"model"``; rank 0
    writes the full results."""
    from chip_smoke import step_agreement
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pmesh
    from repro_torch.training import AdamWConfig
    from repro_torch.training.grad_compress import compressed_psum
    from repro_torch.training.trainer import (distribute_batch, distribute_state, init_train_state, loss_and_grads,
                                              make_train_step)

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(registry.get("smollm-360m").tiny(), dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=g).to(dev)
    lengths = torch.tensor([40, 9], dtype=torch.int32, device=dev)  # row 1 in the first 32-slot shard only
    results, mine = {"backend": torch.distributed.get_backend()}, {}
    _, one = lm.prefill(cfg, params, {"tokens": tokens}, pad_to=64)
    one = one._replace(length=lengths)
    tok = tokens[:, :1]
    results["one"], _ = lm.decode_step(cfg, params, tok, one)
    ops.reset_launch_counts()
    with sharding.use_rules(dm, SP_RULES):
        dp = sharding.distribute_tree(params, lm.param_specs(cfg))
        _, caches = lm.prefill(cfg, dp, {"tokens": tokens}, pad_to=64)
        logits, _ = lm.decode_step(cfg, dp, tok, caches._replace(length=lengths))
        results["sp"] = full(logits)
    results["one"] = results["one"].cpu()
    mine["launches"] = ops.launch_counts()
    # one train step
    model = build(cfg)
    state = init_train_state(model, torch.Generator(dev).manual_seed(2), dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(dev),
             "labels": torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(dev)}
    step = make_train_step(model, AdamWConfig(warmup_steps=1))
    s1, m1 = step(state, batch)
    with sharding.use_rules(dm, {"embed": None}):
        s2, m2 = step(distribute_state(model, state), batch)
        got = [full(x) for x in tree_leaves(s2.params)], [full(x) for x in tree_leaves(s2.opt.mu)]
    results["loss"] = (float(m1["loss"]), float(full(m2["loss"])))
    # the step's moments and update against the single process's (the step
    # is out of place: state holds the parameters before it)
    p0, want = tree_leaves(state.params), (tree_leaves(s1.params), tree_leaves(s1.opt.mu))
    results["step1"] = step_agreement(p0, *got, *want)
    results["no_update"] = step_agreement(p0, p0, [torch.zeros_like(x) for x in want[1]], *want)
    # the grouped MoE's sharded combine under autograd: f32 gradients
    mcfg = dataclasses.replace(registry.get(MOE_ARCH).tiny(), dtype="float32", moe_dispatch="grouped")
    mmodel = build(mcfg)
    mparams = mmodel.init_params(torch.Generator(dev).manual_seed(3), dev)
    mbatch = {k: torch.randint(0, mcfg.vocab_size, (2, 64), generator=g).to(dev) for k in ("tokens", "labels")}
    _, _, want = loss_and_grads(mmodel, mparams, mbatch)
    with sharding.use_rules(dm, {"embed": None}):
        dp = sharding.distribute_tree(mparams, mmodel.param_specs())
        _, _, got = loss_and_grads(mmodel, dp, distribute_batch(mbatch))
        got = [full(x) for x in tree_leaves(got)]
    results["moe_grads"] = [float((a - b.cpu()).abs().max() / b.abs().max().clamp_min(1e-30).cpu())
                            for a, b in zip(got, tree_leaves(want))]
    # compressed_psum over the ranks of "model"
    x = torch.randn(300, 7, generator=torch.Generator().manual_seed(10 + rank)).to(dev) * (rank + 1)
    with sharding.use_rules(dm):
        mine["psum"] = compressed_psum(x, "model").cpu()
    mine["x"], mine["staged"] = x.cpu(), dict(pmesh.STAGED)
    _save(directory, rank, results)
    return mine
