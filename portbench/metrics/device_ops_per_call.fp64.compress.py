"""Device operations (kernels, memsets, copies) per compress call, as
``device_ops_per_call.compress`` (``tracing.ops_per_call``), read only where
every codec kernel of the record is B6 or B8 (``kernels64``); None on any
other. A copy the fp64 path makes of the caller's tensor shows as one more."""

from portbench import kernels64, tracing


def read(rec):
    return tracing.ops_per_call(rec, "compress") if kernels64.only_fp64_nd(rec) else None
