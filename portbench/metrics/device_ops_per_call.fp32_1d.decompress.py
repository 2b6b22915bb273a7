"""Device operations (kernels, memsets, copies) per decompress call, as
``device_ops_per_call.decompress`` (``tracing.ops_per_call``), read only
where every codec kernel of the record is B1 or B2 (``kernels32_1d``); None
on any other."""

from portbench import kernels32_1d, tracing


def read(rec):
    return tracing.ops_per_call(rec, "decompress") if kernels32_1d.only_fp32_1d(rec) else None
