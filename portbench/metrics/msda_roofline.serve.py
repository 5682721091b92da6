"""The MSDA sampling step's kernels (quantize and gather, or the exact
forward) against the least time of the step's calls in the traced
window."""

from portbench.readers import MSDA_FORWARD, roofline_percent


def read(rec):
    return roofline_percent(rec, MSDA_FORWARD)
