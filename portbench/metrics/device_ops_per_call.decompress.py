"""Device operations (kernels, memsets, copies) per decompress call."""

from portbench import tracing


def read(rec):
    return tracing.ops_per_call(rec, "decompress")
