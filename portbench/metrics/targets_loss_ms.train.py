"""Mean device ms of the train step's targets and loss phases together (on-
device costs, the Hungarian kernel, the losses)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "targets", "loss")
