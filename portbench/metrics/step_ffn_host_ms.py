"""The program's ``step.ffn`` spans (a layer's _mlp_residual in lm.decode_step) summed over the window, a decode step, in ms."""
from pbench import program


def read(run):
    return program.per_step_ms(run, 'step.ffn')
