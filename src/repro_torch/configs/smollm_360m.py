"""smollm-360m [dense] — 32L d960 15H (GQA kv=5) ff2560 vocab49152, llama arch.

[hf:HuggingFaceTB/SmolLM-135M family; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_head=64,
    d_ff=2560,
    vocab_size=49152,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
)
