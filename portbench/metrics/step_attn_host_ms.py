"""The program's ``step.attn`` spans (a layer's norm and attn_decode in lm.decode_step) summed over the window, a decode step, in ms."""
from pbench import program


def read(run):
    return program.per_step_ms(run, 'step.attn')
