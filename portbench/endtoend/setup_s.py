"""Seconds from the process's start to the window's first timed call."""


def read(run):
    return run.setup_s
