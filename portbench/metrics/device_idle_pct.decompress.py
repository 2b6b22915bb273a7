"""Share of the decompress calls' time in which no kernel and no copy runs on
the card, in %."""

from portbench import tracing


def read(rec):
    return tracing.idle_pct(rec, "decompress")
