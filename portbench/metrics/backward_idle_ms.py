"""Device-idle ms a unit inside the program's ``pairnet.train.backward`` spans."""

from portbench import program


def read(rec):
    return program.idle_ms(rec, "train.backward")
