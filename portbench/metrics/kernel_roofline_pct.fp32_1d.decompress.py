"""Share of the roofline of B1 and B2 in the decompress calls, in %: as
``kernel_roofline_pct.decompress`` (``tracing.roofline_pct``), read only where
every codec kernel of the record is B1 or B2 (``kernels32_1d``); None on
any other."""

from portbench import kernels32_1d, tracing


def read(rec):
    return tracing.roofline_pct(rec, "decompress") if kernels32_1d.only_fp32_1d(rec) else None
