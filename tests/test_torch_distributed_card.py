"""Card tests of the port's collectives (``-m gpu``; they skip without a
card): two ranks on one card (gloo, the rule for ranks that share a card;
DTensor's gather staged through pinned host memory) run the
sequence-parallel decode and one sharded train step of smollm-360m
``.tiny()`` in bf16 against the single-process path (K3, K4; the step's
moments and update under ``chip_smoke.step_held``), the grouped MoE's
f32 gradients through the sharded combine, and
``compressed_psum``; NCCL over two cards skips with fewer than two.  This
file imports no JAX: the card's machine has none.
"""
import numpy as np
import pytest
import torch

import _torch_dist_world as world


@pytest.fixture(scope="module")
def two_ranks_one_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.mesh import Mesh, backend_for, run_ranks

    dev = torch.device("cuda", 0)
    mesh = Mesh(np.array([[dev, dev]], dtype=object), ("data", "model"))
    assert backend_for(mesh) == "gloo"
    tmp = tmp_path_factory.mktemp("card")
    per_rank = run_ranks(world.card_scenarios, mesh, (str(tmp),), timeout_s=300.0)
    return torch.load(tmp / world.RESULTS, weights_only=False), per_rank


@pytest.mark.gpu
def test_sequence_parallel_decode_on_one_card(two_ranks_one_card):
    results, per_rank = two_ranks_one_card
    assert results["backend"] == "gloo"
    want, got = results["one"].float(), results["sp"].float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    for mine in per_rank:  # the sharded prefill ran K4 on each rank; K3 stays off the mesh path
        assert mine["launches"]["flash_attention"] > 0 and mine["launches"]["decode_attention"] == 0


@pytest.mark.gpu
def test_sharded_train_step_on_one_card(two_ranks_one_card):
    """The loss before the update, then the update itself: the first
    moments (0.1 of the clipped gradient) and the new parameters against
    the single process's step under phase 16 E's rule, which must reject a
    step that changes nothing."""
    from chip_smoke import step_held

    results, _ = two_ranks_one_card
    one, sharded = results["loss"]
    assert abs(one - sharded) <= 5e-3
    assert step_held(results["step1"]), results["step1"]
    assert not step_held(results["no_update"]), results["no_update"]


@pytest.mark.gpu
def test_sharded_moe_gradients_on_one_card(two_ranks_one_card):
    """The grouped MoE's sharded combine (ff split over the two ranks)
    under autograd on the card: every f32 gradient leaf within 2e-5 of its
    largest |value| of the single process's."""
    results, _ = two_ranks_one_card
    assert results["moe_grads"] and max(results["moe_grads"]) <= 2e-5, results["moe_grads"]


@pytest.mark.gpu
def test_compressed_psum_on_one_card(two_ranks_one_card):
    _, per_rank = two_ranks_one_card
    xs = torch.stack([m["x"] for m in per_rank])
    exact, bin_ = xs.mean(0), float(xs.abs().max() / 127)
    for mine in per_rank:
        assert (mine["psum"] - exact).abs().max() <= bin_ * 1.01 + 1e-7
        assert mine["staged"]["calls"] > 0  # gloo on the card: the gathers went through host memory


@pytest.mark.gpu
def test_nccl_over_two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL refuses two ranks on one card")
    from repro_torch.launch.mesh import Mesh, backend_for, run_ranks

    mesh = Mesh(np.array([[torch.device("cuda", 0), torch.device("cuda", 1)]], dtype=object), ("data", "model"))
    assert backend_for(mesh) == "nccl"
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        per_rank = run_ranks(world.card_scenarios, mesh, (tmp,), timeout_s=300.0)
        results = torch.load(f"{tmp}/{world.RESULTS}", weights_only=False)
    assert results["backend"] == "nccl"
    want, got = results["one"].float(), results["sp"].float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    xs = torch.stack([m["x"] for m in per_rank])
    assert all((m["psum"] - xs.mean(0)).abs().max() <= float(xs.abs().max() / 127) * 1.01 + 1e-7 for m in per_rank)
