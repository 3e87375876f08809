"""Architecture config schema covering all assigned families.

One frozen dataclass describes every selectable architecture
(``--arch <id>``); family-specific fields are zero/empty when unused.
``tiny()`` derives the reduced smoke-test variant of any config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int

    # block options
    qkv_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    parallel_block: bool = False  # command-r style attn ∥ FFN
    rope_theta: float = 10_000.0
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"  # global (one sort) | grouped (per-dp-shard)
    moe_groups: int = 32  # dispatch groups for "grouped" (>= dp shards)
    # replicate the d_model dim of expert weights (ff stays TP-sharded):
    # avoids GSPMD partial-sum all-reduces of (groups, E, cap, .) activations
    # when d is FSDP-sharded (§Perf iteration 3)
    moe_replicate_d: bool = False

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_block_every: int = 0

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # multimodal frontend stub
    n_prefix_tokens: int = 0  # image/frame prefix length for prefix-LM
    frontend_dim: int = 0  # precomputed embedding dim from the stub

    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full | dots (dots_with_no_batch_dims_saveable)
    attention_impl: str = "xla"  # xla | pallas | pallas_interpret
    attn_chunk: int = 1024  # q-chunking for the xla prefill path
    shard_repeated_kv: bool = False  # constrain GQA-repeated K/V over heads
    # Store K pre-RoPE in the KV cache (rotated at attention-read).  RoPE's
    # position-dependent rotation destroys the token-locality the CacheGen
    # codec exploits (paper Insight 1); pre-RoPE caching restores it
    # (KIVI/KVQuant report the same effect).  Beyond-paper knob.
    prerope_kv_cache: bool = False
    scan_unroll: bool = False  # python-unroll layer loops (cost-analysis mode)

    # which shapes apply (per assignment skip rules)
    supports_long_context: bool = False  # sub-quadratic -> run long_500k
    has_kv_cache: bool = True  # False for pure SSM (codec inapplicable)

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.family not in ("ssm",) and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def kv_channels(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab axis shards
        evenly on the production meshes (MaxText/Megatron-style padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale = dict(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 7),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2))
            if self.n_kv_heads < self.n_heads
            else 4,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            rope_theta=self.rope_theta,
            remat=False,
        )
        if self.family in ("moe",):
            scale.update(n_experts=8, n_shared_experts=min(self.n_shared_experts, 2),
                         moe_topk=min(self.moe_topk, 2), d_ff=64)
        if self.family in ("ssm", "hybrid"):
            # d_inner = ssm_expand * d_model = 256 -> 8 heads x 32
            scale.update(ssm_state=16, ssm_heads=8, ssm_headdim=32, ssm_chunk=16)
        if self.family == "hybrid":
            scale.update(shared_block_every=3)
        if self.family == "encdec":
            scale.update(enc_layers=2, dec_layers=2)
        if self.family == "vlm":
            scale.update(n_prefix_tokens=8, frontend_dim=64)
        if self.frontend_dim:
            scale.setdefault("frontend_dim", 64)
        return dataclasses.replace(self, name=self.name + "-tiny", **scale)
