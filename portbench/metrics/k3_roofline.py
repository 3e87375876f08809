"""K3's least time from each decode step's cached lengths (yardstick.k3_bound_s) over its traced device time (split and merge launches), in percent."""
from pbench import readers, yardstick


def read(run):
    return readers.k3_roofline_pct(run)
