"""Mean device ms of the train step's optimizer phase (CUDA events from the
step's on_phase hook; see kinds/train.py)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "optimizer")
