"""Share of the roofline of B6 and B8 in the compress calls, in %: as
``kernel_roofline_pct.compress`` (``tracing.roofline_pct``), read only where
every codec kernel of the record is B6 or B8 (``kernels64``); None on any
other."""

from portbench import kernels64, tracing


def read(rec):
    return tracing.roofline_pct(rec, "compress") if kernels64.only_fp64_nd(rec) else None
