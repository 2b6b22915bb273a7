"""Uncompressed GB (10^9 bytes) of every decompress call of the window over the
sum of those calls' times."""


def read(run):
    calls = [c for c in run.calls if c.direction == "decompress"]
    seconds = sum(c.seconds for c in calls)
    return sum(c.in_bytes for c in calls) / seconds / 1e9 if calls and seconds > 0 else None
