"""Serving engine and KV cache layout."""
