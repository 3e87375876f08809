"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d1024 16H (kv=16) ff8192
vocab256206.  [arXiv:2308.11596; hf-verified]

The speech frontend (conformer feature extractor) is a STUB: ``input_specs()``
provides precomputed frame embeddings.  "24L" names the per-stack depth of
the v2 text/unit model: 24 encoder + 24 decoder layers (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,  # total; enc/dec split below
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256206,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    mlp_bias=True,
    frontend_dim=1024,
)
