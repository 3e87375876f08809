"""The program's ``crc`` spans (bitstream.verify_checksum: at the store, in blob validation and in unpack) on every thread, summed a wave over the window's waves, in ms."""
from pbench import program


def read(run):
    return program.wave_ms(run, 'crc')
