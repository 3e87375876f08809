"""End-to-end training driver: a ~100M-parameter llama-family model trained
for a few hundred steps on the synthetic corpus, with checkpointing and
preemption recovery.

Port of ``examples/train_100m.py`` onto ``repro_torch``: the default config
is ~100M params (12L x d512 x ff2048, vocab 8192), trained on the card (K4
in every layer's forward) unless ``--device`` names another; ``--small``
takes smollm-360m's tiny config.

Usage:
  PYTHONPATH=src python examples/torch/train_100m.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import MarkovLM
from repro_torch.models import build
from repro_torch.models.common import Leaf
from repro_torch.training import AdamWConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="results/train_100m")
    ap.add_argument("--small", action="store_true", help="tiny config (CI)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = registry.get("smollm-360m")
    if args.small:
        cfg = base.tiny()
    else:
        cfg = dataclasses.replace(
            base, name="smollm-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, d_head=64, d_ff=2048, vocab_size=8192, remat=False,
        )
    model = build(cfg)
    plan_params = sum(int(np.prod(l.shape)) for l in tree_leaves(model.param_plan(),
                                                                  is_leaf=lambda x: isinstance(x, Leaf)))
    print(f"[train] {cfg.name}: ~{plan_params/1e6:.1f}M params")

    lm = MarkovLM(vocab_size=cfg.vocab_size, seed=5)

    def batch_fn(step):
        rng = np.random.default_rng(10_000 + step)
        toks = np.stack([lm.sample(rng, args.seq + 1) for _ in range(args.batch)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    ck = CheckpointManager(args.ckpt_dir, keep=2)
    tr = Trainer(
        model=model,
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=50),
        batch_fn=batch_fn,
        ckpt=ck,
        ckpt_every=50,
        log_every=10,
        device=args.device,
    )
    state = tr.init_or_restore(seed=0)
    state, hist = tr.run(state, args.steps)
    print(f"[train] done: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")


if __name__ == "__main__":
    main()
