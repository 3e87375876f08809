"""The program's counter ``crc_bytes`` (blob bytes read by checksum passes) over ``wire_bytes`` (blob bytes the transport handed to the sessions) in the window: checksum passes a fetched byte."""
from pbench import program


def read(run):
    return program.crc_passes(run)
