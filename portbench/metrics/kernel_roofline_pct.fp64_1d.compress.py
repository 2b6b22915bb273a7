"""Share of the roofline of B5 and B7 in the compress calls, in %: as
``kernel_roofline_pct.compress`` (``tracing.roofline_pct``), read only where
every codec kernel of the record is B5 or B7 (``kernels64_1d``); None on
any other."""

from portbench import kernels64_1d, tracing


def read(rec):
    return tracing.roofline_pct(rec, "compress") if kernels64_1d.only_fp64_1d(rec) else None
