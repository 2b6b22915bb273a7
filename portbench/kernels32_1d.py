"""The gate of the fp32 1D metrics: a traced record is read under an
``fp32_1d`` name only where every codec kernel in it is one of the fp32 1D
kernels, B1 (``encode_blocks``) and B2 (``decode_blocks``), so that such a
metric can never read B3-B8."""

from portbench.harness import CODEC_KERNELS

#: the parts of a kernel's name that the other codec kernels have and B1 and B2 lack:
#: B3/B4 (``encode_blocks_nd``, ``decode_blocks_nd_box``, ...) and B5-B8 (``encode_blocks64``, ...)
OTHERS = ("blocks_nd", "blocks64")


def only_fp32_1d(rec) -> bool:
    """Whether ``rec`` (a ``tracing.Record``) holds codec kernels and every
    one of them is B1 or B2."""
    names = [o.name for o in rec.ops if any(k in o.name for k in CODEC_KERNELS)]
    return bool(names) and not any(k in n for n in names for k in OTHERS)
