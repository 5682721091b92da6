"""The window's model FLOPs a second (the forward's, counted from the
configuration's shapes, times the record's passes: 3 in a training step,
forward and backward) as a share of one H100's dense bf16 peak."""

from portbench.readers import mfu_percent


def read(rec):
    return mfu_percent(rec)
