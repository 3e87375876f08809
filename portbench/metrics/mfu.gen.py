"""Model FLOPs of the window's questions and decode steps over the window's wall time and the bf16 peak, in percent (generation cells)."""
from pbench import readers


def read(run):
    return readers.mfu_pct(run)
