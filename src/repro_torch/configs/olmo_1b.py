"""olmo-1b [dense] — 16L d2048 16H (kv=16) ff8192 vocab50304, non-parametric LN.

[arXiv:2402.00838; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    mlp="swiglu",
    tie_embeddings=True,
)
