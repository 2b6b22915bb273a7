"""Share of the compress calls' time in which a host-device copy runs, in %."""

from portbench import tracing


def read(rec):
    return tracing.copy_pct(rec, "compress")
