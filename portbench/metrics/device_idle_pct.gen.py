"""Share of the traced window in which no device operation ran, in percent (generation cells)."""
from pbench import readers


def read(run):
    return readers.idle_pct(run)
