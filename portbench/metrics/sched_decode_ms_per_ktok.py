"""SchedulerResult.wall_decode_s (the scheduler's host timer around decode_chunk_runs and insert_runs, no synchronize of its own) summed over the window, per thousand context tokens loaded."""
from pbench import readers


def read(run):
    return 1e3 * sum(w.wall_decode_s for w in run.waves) / (readers.ctx_tokens(run) / 1e3)
