"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) expert-ff512 vocab49155.

MoE: 40 experts top-8 (fine-grained).
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    n_shared_experts=0,
    moe_topk=8,
    norm="rmsnorm",
    mlp="swiglu",
    tie_embeddings=True,
)
