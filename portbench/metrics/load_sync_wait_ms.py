"""The program's ``sched.sync`` span (the device synchronize at the end of ConcurrentScheduler.run) a wave, in ms: how far the device trailed the host's enqueue of the load."""
from pbench import program


def read(run):
    return program.wave_ms(run, 'sched.sync')
