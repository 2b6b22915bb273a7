"""Device operations (kernels, memsets, copies) per decompress call, as
``device_ops_per_call.decompress`` (``tracing.ops_per_call``), read only
where every codec kernel of the record is B5 or B7 (``kernels64_1d``); None
on any other. A copy of a stream at an odd u32 offset (``realign64``)
shows as one more."""

from portbench import kernels64_1d, tracing


def read(rec):
    return tracing.ops_per_call(rec, "decompress") if kernels64_1d.only_fp64_1d(rec) else None
