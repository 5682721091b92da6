"""Search steps of the Hungarian (``batched_hungarian.steps``, counted on the
device while the port's tracer is on) over the measured window, a step."""

from portbench import program


def read(rec):
    return program.per_unit_count(rec, "batched_hungarian.steps")
