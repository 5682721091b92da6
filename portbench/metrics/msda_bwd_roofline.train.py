"""The MSDA backward's kernels against the least time of the backward calls
in the traced window (PERF.md §6 row 6's work, from shapes)."""

from portbench.readers import MSDA_BACKWARD, roofline_percent


def read(rec):
    return roofline_percent(rec, MSDA_BACKWARD)
