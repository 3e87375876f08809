"""Mean of the harness's span around each stacked decode step, its tokens' host read included, in ms."""
from pbench import readers


def read(run):
    return readers.span_ms(run, 'step')
