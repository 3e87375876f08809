"""The 95th percentile, nearest rank, of the gaps between consecutive
tokens of a request, over every token of the window, in ms: the time per
output token's tail.  A per-layer metric because runs of the same seeds
move it by 10-12% from one to the next on a shared host (the step is
host-bound), too close to half the largest bound for an end-to-end one."""
from pbench import readers, yardstick


def read(run):
    return yardstick.percentile(readers.token_gaps_ms(run), 95)
