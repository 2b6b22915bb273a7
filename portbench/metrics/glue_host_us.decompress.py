"""Median per decompress call of the host time in ``codec_cuda``'s glue, in us:
a call's exit less its entry less its ns inside ``_launch``, over the
decompress calls of the program's ring of host times
(``codec_cuda.host_times``) that were made with no span recorded. Read after
the window, when the ring holds the window's last, untraced calls, so no
profiler's cost is in it. None where the program has no ring or the ring
holds no such call (the CPU)."""

import statistics
import sys


def read(rec):
    host_times = getattr(sys.modules.get("ndzip_tpu_torch.codec_cuda"), "host_times", None)
    if host_times is None:
        return None
    us = [(c.exit_ns - c.entry_ns - c.launch_ns) / 1e3 for c in host_times()
          if c.direction == "decompress" and not c.spanned]
    return statistics.median(us) if us else None
