"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``src/repro/launch/train.py``: trains the architecture's
``.tiny()`` config on the in-repo ``MarkovLM`` task (batches seeded per
step), checkpointed and preemption-safe through ``--ckpt-dir``: a second
run with the same directory resumes from its latest checkpoint.

The port against the reference launcher:

* The same flags, plus ``--device`` (default: the CUDA card; with none, the
  port's "no CUDA device" error, never a silent CPU run), as
  ``launch.serve`` has it.
* ``--tiny`` is ``store_true`` with ``default=True`` in the reference, so it
  can never be turned off: both launchers always train ``.tiny()``.
* Weights come from ``torch.Generator(device).manual_seed(0)`` where the
  reference draws ``jax.random.PRNGKey(0)``, so the printed losses differ.
* A run resumed at or past ``--steps`` runs no step; the reference then
  fails on its empty history (an ``IndexError``), the port prints that
  there was no step to run and exits 0.
* :func:`run` returns the trainer's history; :func:`main` is the command
  line.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import MarkovLM
from repro_torch.models import build
from repro_torch.training import AdamWConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    # the port's own flag: the reference launcher has none
    ap.add_argument("--device", default=None,
                    help="port only: torch device to train on (default: the "
                         "CUDA card; with no card the launcher raises "
                         "rather than run on the CPU; pass 'cpu' for that)")
    return ap


def run(argv: Optional[List[str]] = None, *, device=None) -> Dict[str, list]:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print the
    reference's lines and return the trainer's history (``loss`` and
    ``step`` of each logged step).  ``device`` overrides ``--device``."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = registry.get(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    model = build(cfg)
    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=0)

    def batch_fn(step):
        rng = np.random.default_rng(31_337 + step)
        toks = np.stack([lm.sample(rng, args.seq + 1) for _ in range(args.batch)])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.normal(size=(args.batch, args.seq, cfg.frontend_dim)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.normal(
                size=(args.batch, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
        return batch

    ck = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    tr = Trainer(
        model=model,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1)),
        batch_fn=batch_fn,
        ckpt=ck,
        ckpt_every=max(args.steps // 4, 1),
        grad_compression=args.grad_compression,
        log_every=10,
        device=dev,
    )
    state = tr.init_or_restore(0)
    state, hist = tr.run(state, args.steps)
    if hist["loss"]:
        print(f"[launch.train] {cfg.name}: loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}")
    else:
        print(f"[launch.train] {cfg.name}: no step to run, at step {int(state.step)} of {args.steps}")
    return hist


def main() -> None:
    run()


if __name__ == "__main__":
    main()
