"""Training loop: an eager train step and a fault-tolerant outer loop.

Port of ``src/repro/training/trainer.py``.  The step is
``torch.autograd.grad`` of ``model.loss_fn`` (the reference's
``jax.value_and_grad``), optional error-feedback compression, then AdamW;
it runs eagerly (the reference jits it).  The outer loop is
preemption-safe: state is checkpointed every ``ckpt_every`` steps through
the atomic :class:`~repro_torch.checkpoint.CheckpointManager`, and the loop
resumes from ``LATEST`` with the batch sequence regenerated, since
``batch_fn`` is seeded from the global step.  On the card a resumed run
equals an uninterrupted one bit for bit only under
``torch.use_deterministic_algorithms(True)`` (the embedding's backward
accumulates with atomics otherwise).

Sharded (the reference's GSPMD step under ``sharding.use_rules``): inside
``use_rules`` with a process-group ``DeviceMesh``, :func:`distribute_state`
puts the parameters, moments and carried errors on the mesh by
``model.param_specs()``, the step puts each batch leaf on it by
``("batch", "seq", ...)``, and the model constrains its activations; the
loss, its backward and AdamW then run on DTensors with the same code.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import sharding
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.grad_compress import ef_compress, ef_init

__all__ = ["TrainState", "init_train_state", "loss_and_grads", "make_train_step", "distribute_state",
           "distribute_batch", "Trainer"]


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState
    ef_error: Optional[Any]  # error-feedback residuals (None if disabled)
    step: torch.Tensor  # () int32


def init_train_state(model: Model, generator: torch.Generator, device, *,
                     grad_compression: bool = False) -> TrainState:
    """Fresh weights from ``generator`` (on ``device``), zero moments."""
    params = model.init_params(generator, device)
    return TrainState(
        params=params,
        opt=opt_lib.init_opt_state(params),
        ef_error=ef_init(params) if grad_compression else None,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def distribute_state(model: Model, state: TrainState) -> TrainState:
    """``state`` (full tensors, the same on every rank) on the installed
    process-group mesh: parameters, moments and carried errors placed by
    ``model.param_specs()``, the step counts replicated."""
    specs = model.param_specs()

    def by_spec(tree):
        return None if tree is None else sharding.distribute_tree(tree, specs)

    return TrainState(
        params=by_spec(state.params),
        opt=opt_lib.OptState(mu=by_spec(state.opt.mu), nu=by_spec(state.opt.nu),
                             step=sharding.distribute(state.opt.step, ())),
        ef_error=by_spec(state.ef_error),
        step=sharding.distribute(state.step, ()),
    )


def distribute_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each batch leaf on the installed process-group mesh, split over
    ``"batch"`` on its first dimension and ``"seq"`` on its second; as it
    is without such a mesh."""
    return {k: sharding.distribute(v, ("batch", "seq") + (None,) * (v.ndim - 2)) for k, v in batch.items()}


def loss_and_grads(model: Model, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``: grads in
    the parameters' dtypes and tree, zero for a weight the loss does not
    reach (as ``jax.grad`` gives)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)


def make_train_step(
    model: Model, opt_cfg: opt_lib.AdamWConfig, *, grad_compression: bool = False
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict]]:
    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grads(model, state.params, distribute_batch(batch))
        ef_error = state.ef_error
        if grad_compression:
            grads, ef_error = ef_compress(grads, ef_error)
        params, opt, om = opt_lib.apply_updates(state.params, grads, state.opt, opt_cfg)
        metrics = dict(metrics, loss=loss, **om)
        return TrainState(params=params, opt=opt, ef_error=ef_error, step=state.step + 1), metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    model: Model
    opt_cfg: opt_lib.AdamWConfig
    batch_fn: Callable[[int], Dict[str, np.ndarray]]  # step -> batch (restart-safe)
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 50
    grad_compression: bool = False
    log_every: int = 10
    log_fn: Callable[[str], None] = print
    device: Any = None  # the CUDA card unless given (``resolve_device``)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init_or_restore(self, seed: int = 0) -> TrainState:
        state = init_train_state(self.model, torch.Generator(self.device).manual_seed(seed), self.device,
                                 grad_compression=self.grad_compression)
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state = self.ckpt.restore(latest, state)
                self.log_fn(f"[trainer] resumed from step {latest}")
        return state

    def run(self, state: TrainState, n_steps: int) -> Tuple[TrainState, Dict[str, list]]:
        step_fn = make_train_step(self.model, self.opt_cfg, grad_compression=self.grad_compression)
        history: Dict[str, list] = {"loss": [], "step": []}
        start = int(state.step)
        t0 = time.time()
        for s in range(start, n_steps):
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in self.batch_fn(s).items()}
            state, metrics = step_fn(state, batch)
            if (s + 1) % self.log_every == 0 or s == start:
                loss = float(metrics["loss"])
                history["loss"].append(loss)
                history["step"].append(s + 1)
                rate = (s + 1 - start) / max(time.time() - t0, 1e-9)
                self.log_fn(
                    f"[trainer] step {s+1}/{n_steps} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.2f} ({rate:.1f} it/s)"
                )
            if self.ckpt is not None and (s + 1) % self.ckpt_every == 0:
                self.ckpt.save(s + 1, state)
        if self.ckpt is not None and int(state.step) > (self.ckpt.latest_step() or -1):
            self.ckpt.save(int(state.step), state)
        return state, history
