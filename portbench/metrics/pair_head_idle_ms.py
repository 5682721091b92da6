"""Device-idle ms a unit inside the program's ``pairnet.pair_head`` spans."""

from portbench import program


def read(rec):
    return program.idle_ms(rec, "pair_head")
