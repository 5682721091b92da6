"""Process CPU ms a unit span took, every thread's, over the measured
window (the port's tracer: ``pairnet.serve`` or ``pairnet.train.step``)."""

from portbench import program


def read(rec):
    return program.unit_cpu_ms(rec)
