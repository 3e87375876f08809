"""Serving engine, KV cache layout and the live adaptive session."""
from repro_torch.serving.engine import Engine  # noqa: F401


def __getattr__(name):
    # Lazy: the session pulls in the streaming package (which itself
    # imports repro_torch.serving submodules) — deferring keeps the import
    # graph acyclic regardless of which package a user imports first.
    if name in ("ServeSession", "SessionResult", "SessionTask", "RunWork",
                "TextWork", "validate_blob"):
        from repro_torch.serving import session

        return getattr(session, name)
    raise AttributeError(name)
