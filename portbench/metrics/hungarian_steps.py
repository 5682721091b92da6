"""Search steps of the Hungarian (``batched_hungarian.steps``, counted on the
device while the port's tracer is on) over the traced run's unprofiled pass
with the tracer on (``trace.traced_program``), a step."""

from portbench import program


def read(rec):
    return program.per_unit_count(rec, "batched_hungarian.steps")
