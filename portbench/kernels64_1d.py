"""The gate of the fp64 1D metrics: a traced record is read under an
``fp64_1d`` name only where every codec kernel in it is one of the fp64 1D
kernels, B5 (``encode_blocks64``) and B7 (``decode_blocks64``), so that such
a metric can never read B1-B4, B6 or B8."""

from portbench.harness import CODEC_KERNELS

#: the part of a kernel's name that the fp64 kernels share and no fp32 codec kernel has
FP64 = "blocks64"
#: the part of a kernel's name that B6 and B8 have and B5 and B7 lack
ND = "blocks64_nd"


def only_fp64_1d(rec) -> bool:
    """Whether ``rec`` (a ``tracing.Record``) holds codec kernels and every
    one of them is B5 or B7."""
    names = [o.name for o in rec.ops if any(k in o.name for k in CODEC_KERNELS)]
    return bool(names) and all(FP64 in n and ND not in n for n in names)
