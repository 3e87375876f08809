"""The port's dry-run tooling against the reference's (``launch/specs.py``,
``launch/dryrun.py``, ``launch/hlo_stats.py``, ``common.abstract_from_plan``)
and ``kernels.ops``' meta route.

Each package's cells are built in a child process of its own: the
reference's needs 256 forced host devices (``XLA_FLAGS``, fixed at JAX's
first use) and builds specs only, with no compile; the port's starts a fake
process group of 256 ranks (one a process).  Each child writes its tree
leaves (path, shape, dtype, spec, placements) to a JSON file, and the
tests compare them.  The port's child also runs the collective counter on a
fake (2, 2) group, and the depth extrapolation at ``.tiny()``.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo_stats, specs
from repro_torch.models import encdec, lm
from repro_torch.models.common import abstract_from_plan

ROOT = Path(__file__).resolve().parents[1]


def _ref():
    """The reference's modules, imported when a test compares with them (the
    card's machine, which runs the ``gpu`` test, has no JAX)."""
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.launch import hlo_stats, specs
    from repro.models import common, encdec, lm

    return types.SimpleNamespace(jnp=jnp, registry=registry, hlo_stats=hlo_stats, specs=specs, common=common,
                                 encdec=encdec, lm=lm)

# the reference's cells: every applicable (config x shape) on the single
# mesh, leaves as [path, shape, dtype] and specs as [path, entries]
REF_CELLS = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import registry
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import SHAPES, cell_applicable, make_cell

def path(p):
    out = []
    for k in p:
        out.append(str(k.idx) if hasattr(k, "idx") else "." + k.name if hasattr(k, "name") else str(k.key))
    return "/".join(out)

def entry(e):
    return list(e) if isinstance(e, tuple) else e

mesh = make_production_mesh()
out = {}
for name in registry.names():
    cfg = registry.get(name)
    for shape in SHAPES:
        if not cell_applicable(cfg, shape)[0]:
            continue
        cell = make_cell(cfg, shape, mesh)
        leaves = jax.tree_util.tree_flatten_with_path(cell.inputs)[0]
        shards = jax.tree_util.tree_flatten_with_path(cell.in_shardings,
                                                      is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        out[name + "|" + shape] = {
            "inputs": [[path(p), list(x.shape), str(x.dtype)] for p, x in leaves],
            "specs": [[path(p), [entry(e) for e in s.spec]] for p, s in shards],
        }
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

# the port's cells on a fake group of 256, then a fake group of 4: the
# collective counter on known redistributes and the depth extrapolation
PORT_CELLS = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch._tree import tree_flatten_with_path
from repro_torch.configs import registry
from repro_torch.launch import dryrun, hlo_stats, specs
from repro_torch.models import sharding

def path(p):
    return "/".join(p)

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def placed(x):
    return [f"Shard({p.dim})" if isinstance(p, Shard) else type(p).__name__ for p in x]

out = {"cells": {}}
mesh = dryrun.fake_mesh((16, 16), ("data", "model"))
for name in registry.names():
    cfg = registry.get(name)
    for shape in specs.SHAPES:
        if not specs.cell_applicable(cfg, shape)[0]:
            continue
        cell = specs.make_cell(cfg, shape, mesh)
        shards = dict(tree_flatten_with_path(cell.in_shardings, is_leaf=lambda x: isinstance(x, sharding.NamedSharding)))
        rows = []
        for p, x in tree_flatten_with_path(cell.inputs):
            spec = shards[p].spec
            want = placed(sharding.placements(sharding.divisible(spec, x.shape, mesh), mesh))
            rows.append([path(p), list(x.shape), str(x.dtype).replace("torch.", ""),
                         placed(x.placements) if isinstance(x, DTensor) else None, want,
                         (x.to_local() if isinstance(x, DTensor) else x).device.type])
        out["cells"][name + "|" + shape] = {
            "inputs": rows, "specs": [[path(p), [entry(e) for e in s.spec]] for p, s in shards.items()]}
dist.destroy_process_group()

mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
x = distribute_tensor(torch.empty(64, 32, dtype=torch.bfloat16, device="meta"), mesh, [Shard(0), Replicate()],
                      src_data_rank=None)
p = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh, [Replicate(), Partial()], run_check=False)
with hlo_stats.CollectiveCounter() as cc:
    x.redistribute(mesh, [Replicate(), Replicate()])
    p.redistribute(mesh, [Replicate(), Replicate()])
out["records"] = [list(r) for r in cc.records]

def metrics(cfg, shape):
    return dryrun._cell_metrics(cfg, shape, mesh, {}, 4)

specs.SHAPES.update(tiny_train=dict(kind="train", seq=32, batch=4), tiny_prefill=dict(kind="prefill", seq=32, batch=4),
                    tiny_decode=dict(kind="decode", seq=64, batch=4))
out["extrapolated"] = {}
for arch, shape in (("smollm-360m", "tiny_train"), ("qwen2-moe-a2.7b", "tiny_prefill"),
                    ("zamba2-2.7b", "tiny_decode"), ("seamless-m4t-large-v2", "tiny_prefill")):
    cfg = registry.get(arch).tiny()
    if cfg.family == "hybrid":  # whole shared-block periods, as the registry's config has
        cfg = dataclasses.replace(cfg, n_layers=3 * cfg.shared_block_every)
    c1, c2, (k1, k2, K) = dryrun._reduced_pair(cfg)
    out["extrapolated"][arch + "|" + shape] = {
        "full": metrics(cfg, shape), "extrapolated": dryrun._extrapolate(metrics(c1, shape), metrics(c2, shape), k1, k2, K)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _child(code, out, env=None):
    return subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **(env or {})))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(the reference's cells, the port's child output), built side by side."""
    tmp = tmp_path_factory.mktemp("cells")
    ref = _child(REF_CELLS, tmp / "ref.json", {"XLA_FLAGS": "--xla_force_host_platform_device_count=256",
                                               "JAX_PLATFORMS": "cpu"})
    port = _child(PORT_CELLS, tmp / "port.json")
    for name, proc in (("reference", ref), ("port", port)):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"the {name} child failed: {err[-3000:]}"
    return json.loads((tmp / "ref.json").read_text()), json.loads((tmp / "port.json").read_text())


# ---------------------------------------------------------------------------
# specs: shapes, rules and cells against the reference's
# ---------------------------------------------------------------------------


def test_shapes_equal_the_reference():
    assert specs.SHAPES == _ref().specs.SHAPES


@pytest.mark.parametrize("arch", registry.names())
def test_applicability_and_rules_equal_the_reference(arch):
    jspecs, jregistry = _ref().specs, _ref().registry
    assert registry.names() == jregistry.names()
    for shape in specs.SHAPES:
        assert specs.cell_applicable(registry.get(arch), shape) == jspecs.cell_applicable(jregistry.get(arch), shape)
        assert specs.rules_for(registry.get(arch), shape) == jspecs.rules_for(jregistry.get(arch), shape)


def test_long_context_is_skipped_for_the_quadratic_configs():
    skipped = [a for a in registry.names() if not specs.cell_applicable(registry.get(a), "long_500k")[0]]
    assert len(skipped) == 8 and set(registry.names()) - set(skipped) == {"mamba2-370m", "zamba2-2.7b"}


def test_every_applicable_cell_is_built(cells):
    ref, port = cells
    assert len(ref) == 32 and sorted(ref) == sorted(port["cells"])


@pytest.mark.parametrize("arch", registry.names())
def test_cell_inputs_equal_the_reference(cells, arch):
    """Every input leaf's path, shape and dtype at full width (meta tensors,
    each a DTensor but the caches' lengths) and every logical spec equal
    the reference's; each DTensor is placed by its spec with the axes that
    do not divide dropped."""
    ref, port = cells
    for key in (k for k in ref if k.startswith(arch + "|")):
        want, got = ref[key], port["cells"][key]
        assert [r[:3] for r in got["inputs"]] == want["inputs"], key
        assert sorted(got["specs"]) == sorted(want["specs"]), key
        for p, _, _, placed, placed_want, device in got["inputs"]:
            assert device == "meta", (key, p)
            if placed is None:
                assert p.endswith(("/.length", "/.src_len")), (key, p)
            else:
                assert placed == placed_want, (key, p)


@pytest.mark.parametrize("arch", registry.names())
def test_abstract_from_plan_equals_the_reference(arch):
    ref = _ref()
    jnp, jcommon, jencdec, jlm = ref.jnp, ref.common, ref.encdec, ref.lm
    cfg, jcfg = registry.get(arch), ref.registry.get(arch)
    plan = (encdec if cfg.family == "encdec" else lm).param_plan(cfg)
    jplan = (jencdec if jcfg.family == "encdec" else jlm).param_plan(jcfg)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = dict(_flat(abstract_from_plan(plan, dtype)))
        want = dict(_flat(jcommon.abstract_from_plan(jplan, jdtype)))
        assert sorted(got) == sorted(want) == sorted(k for k, _ in _flat(plan))
        for k, x in got.items():
            assert x.device.type == "meta"
            assert (tuple(x.shape), str(x.dtype).replace("torch.", "")) == (tuple(want[k].shape), str(want[k].dtype))


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------------------
# hlo_stats: the reference's HLO cases as records, and the dispatch mode
# ---------------------------------------------------------------------------

REF_HLO = """
  %ag.1 = bf16[16,1024]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[256]T(1,0), dimensions={0}
  %ar.2 = f32[8,8]{1,0} all-reduce(%y), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%sum
  %rs.3 = f32[4]{0} reduce-scatter(%z), channel_id=3, replica_groups=[4,64]<=[256]
  %cp.4 = u8[100]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %notacoll = f32[2,2]{1,0} add(%a, %b)
"""
REF_RECORDS = [hlo_stats.Record("all-gather", 16 * 1024 * 2, 16), hlo_stats.Record("all-reduce", 8 * 8 * 4, 4),
               hlo_stats.Record("reduce-scatter", 4 * 4, 64), hlo_stats.Record("collective-permute", 100, None)]
REF_ASYNC = """
  %ags = bf16[128]{0} all-gather-start(%x), replica_groups={{0,1}}
  %agd = bf16[128]{0} all-gather-done(%ags)
"""


@pytest.mark.parametrize("case", ["parses_shapes_and_groups", "skips_async_done"])
def test_collective_stats_equals_the_reference(case):
    hlo, records, mesh = ((REF_HLO, REF_RECORDS, 256) if case == "parses_shapes_and_groups"
                          else (REF_ASYNC, [hlo_stats.Record("all-gather", 128 * 2, 2)], 2))
    got, want = hlo_stats.collective_stats(records, mesh), _ref().hlo_stats.collective_stats(hlo, mesh)
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes, rel=1e-12)
    assert got.total_result_bytes == want.total_result_bytes


def test_collective_counter_counts_known_redistributes(cells):
    """On a fake (2, 2) group: a (64, 32) bf16 ``Shard(0) -> Replicate``
    over ``"data"`` is one all-gather of the whole tensor in a group of 2
    (the wait is not counted); an (8, 16) f32 ``Partial -> Replicate`` over
    ``"model"`` one all-reduce of its 512 bytes."""
    _, port = cells
    assert port["records"] == [["all-gather", 64 * 32 * 2, 2], ["all-reduce", 8 * 16 * 4, 2]]
    st = hlo_stats.collective_stats([hlo_stats.Record(*r) for r in port["records"]], 4)
    assert st.wire_bytes["all-gather"] == 64 * 32 * 2 / 2 and st.wire_bytes["all-reduce"] == 2 * 512 / 2


def test_extrapolation_equals_the_full_depth_count(cells):
    """Eager code counts every layer, so the depth-1 and depth-2 cells
    extended linearly give the full depth's FLOPs and collectives."""
    _, port = cells
    for key, r in port["extrapolated"].items():
        full, ext = r["full"], r["extrapolated"]
        assert ext["flops"] == pytest.approx(full["flops"], rel=1e-12), key
        assert ext["counts"] == pytest.approx({k: float(v) for k, v in full["counts"].items()}), key
        assert ext["wire_bytes"] == pytest.approx(full["wire_bytes"], rel=1e-9), key
        assert full["flops"] > 0, key


# ---------------------------------------------------------------------------
# the dry run's CLI and records
# ---------------------------------------------------------------------------


def test_skipped_cell_record_is_the_reference_reason(tmp_path):
    assert dryrun.main(["--arch", "qwen1.5-110b", "--shape", "long_500k", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen1.5-110b.long_500k.single.json").read_text())
    assert rec == {"arch": "qwen1.5-110b", "shape": "long_500k", "mesh": "single", "status": "skipped",
                   "reason": _ref().specs.cell_applicable(_ref().registry.get("qwen1.5-110b"), "long_500k")[1]}


# ---------------------------------------------------------------------------
# kernels.ops on meta tensors
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ops_on_meta_take_the_plain_versions_and_count_no_launch():
    before = ops.launch_counts()
    u16 = torch.uint16
    assert ops.kv_dequant_tokens(_meta(2, 3, 9, 8, dtype=u16), _meta(2, 3, 8), _meta(2), qmax=127).shape == (2, 3, 10, 8)
    assert ops.kv_lossless_tokens(_meta(2, 3, 9, 8, dtype=u16), _meta(2, 3, 8, dtype=u16), _meta(2, 3)).shape \
        == (2, 3, 10, 8)
    q8 = ops.kv_quant(_meta(2, 3, 10, 8), _meta(2), qmax=127)
    assert (q8.shape, q8.dtype) == ((2, 3, 9, 8), u16)
    assert ops.kv_dequant(_meta(2, 3, 9, 8, dtype=u16), _meta(2, 3, 8), _meta(2), qmax=127).shape == (2, 3, 9, 8)
    o = ops.decode_attention(_meta(2, 8, 64, dtype=torch.bfloat16), _meta(2, 40, 4, 64, dtype=torch.bfloat16),
                             _meta(2, 40, 4, 64, dtype=torch.bfloat16), torch.zeros(2, dtype=torch.int32, device="meta"))
    assert (o.shape, o.dtype, o.device.type) == ((2, 8, 64), torch.bfloat16, "meta")
    q = _meta(2, 24, 8, 64).requires_grad_()
    o = ops.flash_attention(q, _meta(2, 24, 4, 64), _meta(2, 24, 4, 64))
    assert o.shape == (2, 24, 8, 64) and o.grad_fn is not None  # the card's autograd Function
    o.sum().backward()
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    assert ops.launch_counts() == before


def test_ops_refuse_another_device_type():
    other = types.SimpleNamespace(is_cuda=False, device=torch.device("xpu"), shape=(1, 4, 1, 8))
    with pytest.raises(ValueError, match="no kernel for tensors on xpu"):
        ops.kv_quant(other, None, qmax=127)
    with pytest.raises(ValueError, match="no kernel for tensors on xpu"):
        ops.flash_attention(other, _meta(1, 4, 1, 8), _meta(1, 4, 1, 8))


def test_decode_attention_under_grad_on_meta_raises_as_on_the_card():
    q = _meta(1, 2, 8).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, _meta(1, 4, 1, 8), _meta(1, 4, 1, 8), torch.zeros(1, dtype=torch.int32, device="meta"))


def test_flop_counter_counts_attention_by_the_plain_versions_rule():
    """Under the dry run's counter each K3 and K4 call counts its plain
    version's product FLOPs once, on the CPU (where the counter also sees
    the plain version's own products) and on meta alike."""
    B, T, Hq, Hkv, D, S = 2, 40, 6, 2, 16, 72
    want_k4, want_k3 = 4 * B * Hq * T * T * D, 4 * B * Hq * S * D
    for dev in ("cpu", "meta"):
        q, k = torch.zeros(B, T, Hq, D, device=dev), torch.zeros(B, T, Hkv, D, device=dev)
        with hlo_stats.FlopCounter() as fc:
            ops.flash_attention(q, k, k)
        assert fc.flops == want_k4, dev
        with hlo_stats.FlopCounter() as fc:
            ops.decode_attention(q[:, 0], torch.zeros(B, S, Hkv, D, device=dev), torch.zeros(B, S, Hkv, D, device=dev),
                                 torch.full((B,), S, dtype=torch.int32, device=dev))
        assert fc.flops == want_k3, dev
    assert ops.FLOP_COUNTERS == []
    # the plain version's own products, as torch's counter counts them
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fm:
        ops.flash_attention(torch.zeros(B, T, Hq, D), torch.zeros(B, T, Hkv, D), torch.zeros(B, T, Hkv, D))
    assert fm.get_total_flops() == want_k4


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 at a tiny size
# ---------------------------------------------------------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_dryrun_path_runs_on_cpu_at_tiny_size(tmp_path, capsys, monkeypatch):
    """Phase 17 off the card: A's dry-run child (``python -m
    repro_torch.launch.dryrun``) on one sub-quadratic cell, B's decode cell
    on meta (a child) and on one gloo rank (the plain K3) with the same
    FLOPs, collectives and argument bytes; and phase 18's host-only example
    against the reference's timeline."""
    smoke = _load_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)  # the rank imports its function by name
    monkeypatch.syspath_prepend(str(ROOT))
    cells, kinds = (("mamba2-370m", "long_500k", "single"),), ("decode",)
    children = smoke.Children(str(tmp_path))
    try:
        smoke.start_host_children(children, tiny=True, cells=cells, kinds=kinds)
        smoke.drive_dryrun_path(torch.device("cpu"), children, tiny=True, cells=cells, kinds=kinds)
        smoke.drive_examples_path(torch.device("cpu"), children, examples={"bandwidth_adaptation": []})
    finally:
        children.close()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    a, b = lines[0], lines[1]
    assert (a["phase"], a["arch"]) == ("17 A", "mamba2-370m") and a["flops"] > 0 and a["counts"]
    assert (b["phase"], b["kind"]) == ("17 B", "decode") and b["flops"] > 0
    rec = json.loads((tmp_path / "mamba2-370m.long_500k.single.json").read_text())
    assert set(rec) >= {"status", "trace_s", "memory", "cost", "collectives", "extrapolated"}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    assert rec["extrapolated"]["flops"] == pytest.approx(rec["cost"]["flops"], rel=1e-12)


@pytest.mark.gpu
def test_chip_smoke_ground_train_cell_on_the_card_at_tiny_size(tmp_path, monkeypatch):
    """Phase 17 B's train cell at ``.tiny()``: the meta run and the card's
    (K4 under autograd) count the same FLOPs and collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _load_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    monkeypatch.syspath_prepend(str(ROOT))
    children = smoke.Children(str(tmp_path))
    try:
        smoke.start_host_children(children, tiny=True, cells=(), kinds=("train",))
        launches = smoke.drive_dryrun_path(torch.device("cuda"), children, tiny=True, cells=(), kinds=("train",))
    finally:
        children.close()
    assert launches["flash_attention"] > 0
