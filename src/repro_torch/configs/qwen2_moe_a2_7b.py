"""qwen2-moe-a2.7b [moe] — 24L d2048 16H (kv=16) expert-ff1408 vocab151936.

MoE: 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf-verified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    moe_topk=4,
    norm="rmsnorm",
    mlp="swiglu",
)
