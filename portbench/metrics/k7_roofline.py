"""K7's least time from the traced calls' shapes (yardstick.k7_bound_s) over its traced device time, in percent."""
from pbench import readers, yardstick


def read(run):
    return readers.k7_roofline_pct(run)
