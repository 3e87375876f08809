"""mamba2-370m [ssm] — 48L d1024, attention-free, ssm_state=128, vocab 50280.

SSD (state-space duality).  [arXiv:2405.21060; unverified]

CacheGen applicability: attention-free -> no KV cache; the paper's technique
does not apply (DESIGN.md §Arch-applicability).  Long-context shapes run.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=32,  # d_inner / ssm_headdim = 2048 / 64
    ssm_headdim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    norm="rmsnorm",
    supports_long_context=True,
    has_kv_cache=False,
)
