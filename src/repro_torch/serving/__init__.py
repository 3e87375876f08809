"""Serving engine, KV cache layout, the live adaptive session and the
multi-request schedulers."""
from repro_torch.serving.engine import Engine  # noqa: F401


def __getattr__(name):
    # Lazy: session/scheduler pull in the streaming package (which itself
    # imports repro_torch.serving submodules) — deferring keeps the import
    # graph acyclic regardless of which package a user imports first.
    if name in ("ServeSession", "SessionResult", "SessionTask", "RunWork",
                "TextWork", "validate_blob"):
        from repro_torch.serving import session

        return getattr(session, name)
    if name in ("ConcurrentScheduler", "SessionRequest", "SchedulerResult",
                "ContinuousScheduler", "ContinuousResult", "PreemptionPolicy",
                "RequestTimeline", "RowPool"):
        from repro_torch.serving import scheduler

        return getattr(scheduler, name)
    raise AttributeError(name)
