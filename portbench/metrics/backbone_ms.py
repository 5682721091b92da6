"""Mean device ms a request (a batch, or one image) spent from the start of
the forward (the upload queued) to the backbone's output: CUDA events
recorded by forward hooks at the port's module boundaries
(``BOUNDARIES`` of the family, families/pairnet.py), gaps included."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "backbone")
