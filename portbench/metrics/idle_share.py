"""Share of the traced window in which no kernel, memcpy or memset ran."""

from portbench.readers import idle_percent


def read(rec):
    return idle_percent(rec)
