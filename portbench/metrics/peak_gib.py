"""Peak device memory allocated during the window, GiB."""

from portbench.readers import peak_gib


def read(rec):
    return peak_gib(rec)
