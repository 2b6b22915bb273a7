"""Median per decompress call of the host time inside ``codec_cuda._launch``,
in us: the current device's check, the stream's handle, the ctypes call and
the CUDA runtime's launch (the encoders' status memset too), summed over the
call's launches, over the decompress calls of the program's ring of host
times (``codec_cuda.host_times``) that were made with no span recorded. Read
after the window, when the ring holds the window's last, untraced calls, so
no profiler's cost is in it. None where the program has no ring or the ring
holds no such call (the CPU)."""

import statistics
import sys


def read(rec):
    host_times = getattr(sys.modules.get("ndzip_tpu_torch.codec_cuda"), "host_times", None)
    if host_times is None:
        return None
    us = [c.launch_ns / 1e3 for c in host_times() if c.direction == "decompress" and not c.spanned]
    return statistics.median(us) if us else None
