"""The program's ``codec.h2d`` spans (the payload, scale and bin uploads of codec.decode_chunks from pageable host memory) summed a wave over the window's waves, in ms."""
from pbench import program


def read(run):
    return program.wave_ms(run, 'codec.h2d')
