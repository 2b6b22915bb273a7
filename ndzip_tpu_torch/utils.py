"""Timers and the card's name, shared by ``chip_smoke.py``, ``ubench`` and
``api.Offloader``.

The counterpart of ``ndzip_tpu/utils/__init__.py:device_time_ns``. On the
card a call is timed with CUDA events around it on the current stream: the
device time of the work it enqueues plus any gap the host leaves between its
launches. With ``queued=True`` the work is queued behind a spin kernel
first, so that the events hold the device's time alone (the reference's
``kernel_duration``). A machine without a GPU has no device time to give, so
``device_time_ms`` raises there; host work is timed with ``wall_time_ns``.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


#: the first spin of a queued timing: about 1 ms at the H100's 1.98 GHz
#: clock, several times the host's 0.05-0.4 ms to enqueue one codec call
SPIN_CYCLES = 1 << 21
MAX_SPIN_CYCLES = 1 << 26


def device_time_ms(fn, reps: int = 10, warmup: int = 2, queued: bool = False) -> float:
    """Median over ``reps`` calls of ``fn()`` on the card, in ms, each
    timed by ``event_time_ms(fn, queued)``, after ``warmup`` untimed calls.
    Raises RuntimeError without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device: torch.cuda.is_available() is false")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return statistics.median(event_time_ms(fn, queued)[1] for _ in range(reps))


def event_time_ms(fn, queued: bool = False):
    """``(fn(), ms)``: the result of one call and the time between two CUDA
    events around it on the current stream, read once the second event has
    passed.

    The events hold the device time of the work ``fn`` enqueues and, where
    the device is idle, the time it waits for the host between launches.
    With ``queued``, a spin kernel (``torch.cuda._sleep``) runs before the
    first event, so that ``fn``'s launches queue up behind it and the events
    hold the device's time alone. Where the spin had ended before ``fn``
    returned, ``fn`` runs again behind a spin twice as long, up to
    ``MAX_SPIN_CYCLES`` (past which the host's time counts again); ``fn``
    must not wait for the device."""
    cycles = SPIN_CYCLES
    while True:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        a.record()
        out = fn()
        spun_past = queued and not a.query()  # the device still spun when fn returned
        b.record()
        b.synchronize()
        if not queued or spun_past or cycles >= MAX_SPIN_CYCLES:
            return out, a.elapsed_time(b)
        cycles *= 2


def wall_time_ns(fn):
    """``(fn(), ns)``: the result of one call and its duration on the host's
    clock."""
    t0 = time.perf_counter_ns()
    out = fn()
    return out, time.perf_counter_ns() - t0


def card() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    raises if nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()
