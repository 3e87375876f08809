"""Seconds from the process's start to the window's start: weights, pool, profile, store, warm-up."""


def read(run):
    return run.setup_s
