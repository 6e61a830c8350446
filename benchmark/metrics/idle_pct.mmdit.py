"""Share of the traced window in which no operation ran on the card."""

from benchmark.common.readers import idle_pct


def read(rec):
    return idle_pct(rec)
