"""PyTorch + CUDA port of the CacheGen reproduction (the JAX package ``repro`` is the reference)."""
