"""Timers, the card's name and the observability utilities, shared by
``variants``, ``ubench``, ``bench``, ``benchmark`` and ``api.Offloader``.

The counterpart of ``ndzip_tpu/utils/__init__.py``. On the card a call is
timed with CUDA events around it on the current stream: the device time of
the work it enqueues plus any gap the host leaves between its launches.
With ``queued=True`` the work is queued behind a spin kernel first, so that
the events hold the device's time alone (the reference's
``kernel_duration``). A machine without a GPU has no device time to give,
so ``device_time_ms`` raises there; host work is timed with
``wall_time_ns``.

The reference gates its diagnostics behind ``NDZIP_VERBOSE``
(common.hh:630-633) and profiles each kernel submission
(sycl_bits.hh:38-55). Here:

* ``verbose()``: the ``NDZIP_TORCH_VERBOSE`` gate, read once and cached;
* ``log(...)``: a stderr logger, silent unless verbose;
* ``trace(label)``: a ``torch.profiler.record_function`` span, which shows
  in a profiler trace, and under verbose a ``[profile] <label> <ms>`` line
  of host time; while no profiler records and verbose is off it does one
  check and nothing else, so the program's spans stay in its hot path;
* ``profiler_trace(log_dir)``: a ``torch.profiler`` trace of a region, of
  the CPU and, where a GPU answers, the card, written into ``log_dir`` as a
  Chrome/TensorBoard trace.

The JAX package's persistent compilation cache has no counterpart: the
kernels are compiled ahead of time into one library (``_build``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import profiler as _autograd_profiler


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


#: the environment variable that turns on ``log`` and ``trace``'s lines
VERBOSE_ENV = "NDZIP_TORCH_VERBOSE"


@functools.lru_cache(maxsize=1)
def verbose() -> bool:
    """common.hh:630-633: whether ``NDZIP_TORCH_VERBOSE`` is set to other
    than "", "0", "false" or "no"; read once and cached."""
    return os.environ.get(VERBOSE_ENV, "") not in ("", "0", "false", "no")


def log(*args):
    """Print ``[ndzip-torch] ...`` to stderr under verbose."""
    if verbose():
        print("[ndzip-torch]", *args, file=sys.stderr)


class _Span:
    """``trace``'s span while a profiler records or under verbose."""

    __slots__ = ("label", "_t0", "_rf")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._rf = torch.profiler.record_function(self.label)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        if verbose():
            ms = (time.perf_counter() - self._t0) * 1e3
            print(f"[profile] {self.label} {ms:.3f} ms", file=sys.stderr)
        return False


#: ``trace``'s span while nothing listens: enters nothing, reusable
_OFF = contextlib.nullcontext()


def trace(label: str):
    """A ``torch.profiler.record_function(label)`` span around the region
    (``with trace(label):``), and under verbose a ``[profile] <label> <ms>``
    line of its host time (the analog of submit_and_profile,
    sycl_bits.hh:46-55). The span is entered only while a profiler records
    or under verbose; otherwise the region runs inside a shared no-op, one
    check where an idle ``record_function`` costs over ten times as much.
    The check reads the flag that ``torch.profiler.profile`` and
    ``torch.autograd.profiler.profile`` set while they record, which says
    what ``torch.autograd._profiler_enabled()`` says without a call into
    torch's library: the codec opens two spans a call on its hot path."""
    if _autograd_profiler._is_profiler_enabled or verbose():
        return _Span(label)
    return _OFF


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the region with ``torch.profiler`` (the CPU, and the card
    where ``torch.cuda.is_available()``) and write the trace into
    ``log_dir`` as a Chrome/TensorBoard trace (``*.pt.trace.json``) when it
    ends. Yields the ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
