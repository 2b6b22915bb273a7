"""Per-layer readings from a ``torch.profiler`` trace of a short stretch of
the window.

The benchmark wraps each call in a ``record_function`` span of its own
(``portbench.compress`` / ``portbench.decompress``), so the trace holds the
host's spans beside the card's operations: kernels, memsets and copies. A
device operation belongs to the call in whose span the host made the
runtime call that launched it (``cudaLaunchKernel``, ``cudaMemsetAsync``,
``cudaMemcpyAsync``, matched by the trace's correlation id). The card's
timestamps are not the host's: on an H100 a kernel's start read up to some
40 us before the host's launch of it, as long as a gap between two calls,
so an operation is never placed by its own time on the host's spans. Only
where its launch is missing from the trace does its middle place it; the
record counts those operations (``ops_without_launch``), and the launches
whose operation the trace lost (``launches_without_op``).

Durations are read on one clock each: an operation's on the card's, a
span's on the host's. The readers under ``portbench/metrics/`` call the
functions below on a ``Record``; each returns None where it finds nothing
to read.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from pathlib import Path

#: chrome-trace categories of operations that run on the card
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
COPY_CAT = "gpu_memcpy"
#: chrome-trace categories of the host's calls into the CUDA runtime and driver
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: parts of the names of those calls that put work on the card: kernels, memsets, copies
ENQUEUE = ("Launch", "Memset", "Memcpy")
#: the prefix of the benchmark's own spans
SPAN_PREFIX = "portbench."


@dataclass
class Op:
    name: str
    cat: str
    start: float  # seconds on the trace's clock for the card
    end: float
    launch: float | None = None  # when the host launched it, on the host's clock
    call: int = -1  # the index of the call it belongs to, or -1


@dataclass
class Span:
    name: str
    start: float
    end: float


@dataclass
class TracedCall:
    """One call of the traced stretch: its direction, the bytes the format
    makes it move (``roofline.codec_bytes``), its span and its operations."""

    direction: str
    bound_bytes: int
    start: float
    end: float
    ops: list = field(default_factory=list)


@dataclass
class Record:
    """What a traced run hands the readers."""

    calls: list
    ops: list  # every operation placed in a call of the stretch
    window: tuple  # (start, end) of the traced stretch on the host's clock, seconds
    peak_bytes_per_s: float | None
    #: seconds of non-copy device work per direction where the trace lost
    #: records and CUDA events stood in (see ``harness``)
    kernel_seconds: dict = field(default_factory=dict)
    #: device operations of the trace whose launch record is missing, placed
    #: by their middle on the card's clock or in no call
    ops_without_launch: int = 0
    #: launches of the trace whose device operation is missing (``launches_without_op``)
    launches_without_op: int = 0


def load_events(path) -> list:
    """The events of a chrome trace written by
    ``torch.profiler.profile.export_chrome_trace``."""
    return json.loads(Path(path).read_text()).get("traceEvents", [])


def read_events(events) -> tuple[list, list]:
    """``(spans, ops)`` of a chrome trace's events: the benchmark's spans
    and the card's operations, each with the host's time of its launch
    where the trace has it, each sorted by start."""
    spans, ops, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        start = float(e["ts"]) * 1e-6
        end = start + float(e.get("dur", 0)) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((Op(name, cat, start, end), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = start
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append(Span(name, start, end))
    for op, corr in ops:
        op.launch = launches.get(corr)
    spans.sort(key=lambda s: s.start)
    return spans, sorted((op for op, _ in ops), key=lambda o: o.start)


def launches_without_op(events) -> int:
    """The calls into the CUDA runtime or driver among a chrome trace's
    events that put work on the card (``ENQUEUE``) and whose correlation id
    no device operation of the trace carries: operations the trace lost."""
    device = {(e.get("args") or {}).get("correlation") for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    return sum(e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and any(k in e.get("name", "") for k in ENQUEUE)
               and (e.get("args") or {}).get("correlation") not in device for e in events)


def build_record(spans, ops, calls, peak_bytes_per_s) -> Record:
    """Match the spans to ``calls`` (``(direction, bound_bytes)`` of the
    stretch in order), give each call the operations launched in its span
    and count the operations with no launch. Raises ValueError where the
    spans and the calls do not match one to one."""
    if len(spans) != len(calls):
        raise ValueError(f"the trace holds {len(spans)} spans of the benchmark, the stretch made {len(calls)} calls")
    traced = []
    for span, (direction, bound_bytes) in zip(spans, calls):
        if span.name != SPAN_PREFIX + direction:
            raise ValueError(f"span {span.name} where a {direction} call was made")
        traced.append(TracedCall(direction, bound_bytes, span.start, span.end))
    starts = [c.start for c in traced]
    placed = []
    for op in ops:
        at = op.launch if op.launch is not None else 0.5 * (op.start + op.end)
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= traced[i].end:
            op.call = i
            traced[i].ops.append(op)
            placed.append(op)
    window = (traced[0].start, traced[-1].end) if traced else (0.0, 0.0)
    return Record(traced, placed, window, peak_bytes_per_s,
                  ops_without_launch=sum(op.launch is None for op in ops))


def _union(intervals) -> list:
    """Merge ``(start, end)`` intervals into disjoint ones, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _busy(ops) -> float:
    return sum(e - s for s, e in _union((o.start, o.end) for o in ops))


def calls_of(rec: Record, direction: str) -> list:
    return [c for c in rec.calls if c.direction == direction]


def roofline_pct(rec: Record, direction: str):
    """Least time over device time, in %: the bytes the format makes the
    calls move at the card's peak bandwidth, over the device time of every
    kernel and memset the calls launched (copies left out)."""
    calls = calls_of(rec, direction)
    if not calls or not rec.peak_bytes_per_s:
        return None
    device = rec.kernel_seconds.get(direction)
    if device is None:
        device = sum(o.end - o.start for c in calls for o in c.ops if o.cat != COPY_CAT)
    if device <= 0:
        return None
    return 100.0 * sum(c.bound_bytes for c in calls) / rec.peak_bytes_per_s / device


def _share(calls, pick) -> float | None:
    """The calls' device time of the operations ``pick`` keeps, each call's
    at most its span, as a share of the calls' span time."""
    total = sum(c.end - c.start for c in calls)
    if total <= 0:
        return None
    return sum(min(_busy([o for o in c.ops if pick(o)]), c.end - c.start) for c in calls) / total


def idle_pct(rec: Record, direction: str):
    """Share of the calls' span time in which no operation runs on the card, in %."""
    busy = _share(calls_of(rec, direction), lambda o: True)
    return None if busy is None else 100.0 * (1.0 - busy)


def copy_pct(rec: Record, direction: str):
    """Share of the calls' span time in which a host-device copy runs, in %."""
    calls = calls_of(rec, direction)
    if not any(o.cat == COPY_CAT for c in calls for o in c.ops):
        return None
    return 100.0 * _share(calls, lambda o: o.cat == COPY_CAT)


def ops_per_call(rec: Record, direction: str):
    """Device operations (kernels, memsets, copies) per call."""
    calls = calls_of(rec, direction)
    if not calls:
        return None
    return sum(len(c.ops) for c in calls) / len(calls)


def busy_and_window(rec: Record) -> tuple[float, float]:
    """``(busy_s, window_s)``: seconds in which an operation of the
    stretch's calls ran on the card, and the stretch's length."""
    start, end = rec.window
    return min(_busy(rec.ops), end - start), end - start


def breakdown(rec: Record, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the card between two operations of the stretch,
    each named by what the host was doing: the span of the call both
    operations belong to, or ``between <span> and <span>`` where the gap
    runs from one call into the next: ``{"device_ops": [[name, s], ...],
    "idle_gaps": [[name, s], ...]}``."""
    by_name = {}
    for o in rec.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], None
    for o in sorted(rec.ops, key=lambda o: o.start):
        if last is not None and o.start > last.end:
            a, b = (SPAN_PREFIX + rec.calls[x.call].direction for x in (last, o))
            gaps.append((a if last.call == o.call else f"between {a} and {b}", o.start - last.end))
        if last is None or o.end > last.end:
            last = o
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, s] for n, s in device_ops], "idle_gaps": [[n, s] for n, s in gaps[:top]]}
