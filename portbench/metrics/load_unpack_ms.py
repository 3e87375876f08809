"""The program's ``codec.unpack`` spans (bitstream.unpack) less their ``crc`` children, summed a wave over the window's waves, in ms: the wire's parse and its copies."""
from pbench import program


def read(run):
    return program.unpack_ms(run)
