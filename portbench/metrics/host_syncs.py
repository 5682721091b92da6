"""Host-blocking calls (stream, device and event synchronises, blocking
``cudaMemcpy``) inside the program's unit spans, a unit (``portbench/program.py``);
the client's own copies back lie outside ``pairnet.serve``."""

from portbench import program


def read(rec):
    return program.unit_figure(rec, "syncs")
