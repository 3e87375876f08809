"""paligemma-3b [vlm] — 18L d2048 8H (MQA kv=1) ff16384 vocab257216.

SigLIP vision frontend is a STUB: ``input_specs()`` provides precomputed
patch embeddings; the gemma-style text backbone runs prefix-LM attention
(bidirectional over the image+prefix region).  [arXiv:2407.07726; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=257216,
    norm="rmsnorm",
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    n_prefix_tokens=256,  # 224px / patch 14 -> 256 patches
    frontend_dim=1152,  # SigLIP-So400m width
)
