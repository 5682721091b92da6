"""Device-idle ms a step inside the program's ``pairnet.train.targets`` and
``pairnet.train.loss`` spans."""

from portbench import program


def read(rec):
    return program.idle_ms(rec, "train.targets", "train.loss")
