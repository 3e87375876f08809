"""The paper's baselines (§7.1): uniform quantization of the KV cache and
the H2O / LLMLingua-style context-compression selections."""
from repro_torch.baselines.quantization import int8_wire_bytes, uniform_quantize_kv  # noqa: F401
from repro_torch.baselines.context_compression import h2o_select, llmlingua_select  # noqa: F401
