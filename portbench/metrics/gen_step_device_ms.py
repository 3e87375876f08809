"""Device time (the union of the traced window's device operations) inside the step spans, a step, in ms."""
from pbench import readers


def read(run):
    return readers.step_device_ms(run)
