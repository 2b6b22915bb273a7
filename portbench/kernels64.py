"""The gate of the fp64 metrics: a traced record is read under an fp64 name
only where every codec kernel in it is one of the fp64 2D/3D kernels, B6
(``encode_blocks64_nd``) and B8 (``decode_blocks64_nd``), so that such a
metric can never read B3/B4 or the 1D kernels."""

from portbench.harness import CODEC_KERNELS

#: the part of a kernel's name that B6 and B8 share and no other codec kernel has
FP64_ND = "blocks64_nd"


def only_fp64_nd(rec) -> bool:
    """Whether ``rec`` (a ``tracing.Record``) holds codec kernels and every
    one of them is B6 or B8."""
    names = [o.name for o in rec.ops if any(k in o.name for k in CODEC_KERNELS)]
    return bool(names) and all(FP64_ND in n for n in names)
