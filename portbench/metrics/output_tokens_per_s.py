"""Tokens served in the window (each request's answer) over the window's wall time."""
from pbench import readers


def read(run):
    return readers.output_tokens(run) / run.window_s
