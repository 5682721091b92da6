"""Process CPU ms a unit span took, every thread's, over the traced run's
unprofiled pass with the port's tracer on (``trace.traced_program``; the
units ``pairnet.serve`` or ``pairnet.train.step``)."""

from portbench import program


def read(rec):
    return program.unit_cpu_ms(rec)
