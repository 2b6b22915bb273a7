"""Share of the roofline of the codec's kernels in the decompress calls, in %:
the bytes the format makes them move (``roofline.codec_bytes``) at the
card's peak bandwidth, over the device time of the kernels and memsets they
launched."""

from portbench import tracing


def read(rec):
    return tracing.roofline_pct(rec, "decompress")
