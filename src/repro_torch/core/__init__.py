"""CacheGen core: the paper's KV-cache codec (encode -> stream -> decode)."""
