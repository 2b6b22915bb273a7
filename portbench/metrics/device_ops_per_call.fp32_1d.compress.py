"""Device operations (kernels, memsets, copies) per compress call, as
``device_ops_per_call.compress`` (``tracing.ops_per_call``), read only where
every codec kernel of the record is B1 or B2 (``kernels32_1d``); None on
any other. A copy of a 1D input off 16-byte alignment (``align1d``) shows
as one more."""

from portbench import kernels32_1d, tracing


def read(rec):
    return tracing.ops_per_call(rec, "compress") if kernels32_1d.only_fp32_1d(rec) else None
