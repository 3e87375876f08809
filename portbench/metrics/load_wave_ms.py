"""Mean over the window's waves of the harness's span around ConcurrentScheduler.run (which synchronizes the card at its end), in ms."""
from pbench import readers


def read(run):
    return readers.span_ms(run, 'load')
