"""95th percentile of the times of every decompress call of the window, in ms."""

import numpy as np


def read(run):
    times = [c.seconds for c in run.calls if c.direction == "decompress"]
    return float(np.percentile(times, 95)) * 1e3 if times else None
