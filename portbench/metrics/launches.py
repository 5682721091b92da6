"""Kernel-launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``; a graph launch
counts one) inside the program's unit spans, a unit (``portbench/program.py``)."""

from portbench import program


def read(rec):
    return program.unit_figure(rec, "launches")
