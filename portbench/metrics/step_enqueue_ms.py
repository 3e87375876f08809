"""Mean of the program's ``engine.step`` spans (Engine.decode_step_rows, no token read) in the window, in ms: the host's enqueue of a decode step."""
from pbench import program


def read(run):
    return program.per_step_ms(run, 'engine.step')
