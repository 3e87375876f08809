"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) ff22528 vocab256000.

GQA, no biases, parallel attention+FFN block.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    mlp="swiglu",
    parallel_block=True,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)
