"""Share of the compress calls' time in which no operation runs on the card
(its clock shifted onto the host's) while the host is inside a program span,
in % (``spans.idle_in_program_pct``); the rest of ``device_idle_pct`` is
the caller's. Reads a record that ``spans.attach`` gave the program's
spans; None on any other."""

from portbench import spans


def read(rec):
    return spans.idle_in_program_pct(rec, "compress")
