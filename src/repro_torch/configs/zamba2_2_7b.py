"""zamba2-2.7b [hybrid] — 54L d2560 32H (kv=32) ff10240 vocab32000 ssm_state=64.

Mamba2 backbone with a weight-shared attention+MLP block applied every 6
layers.  [arXiv:2411.15242; hf-verified]

CacheGen applies to the shared-block KV caches (one per application);
Mamba2 layers carry no KV (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=80,  # d_inner / ssm_headdim = 5120 / 64
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    shared_block_every=6,
    norm="rmsnorm",
    mlp="gelu",
    supports_long_context=True,
)
