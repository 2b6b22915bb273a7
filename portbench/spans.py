"""The program's own spans in a traced stretch, on one clock with the card's
operations.

``ndzip_tpu_torch`` opens spans inside its codec layer (``utils.trace``),
recorded only while a profiler records: ``ndzip.compress_device`` and
``ndzip.decompress_device`` around each API call (checks, allocations, the
path's choice, the launch) and ``ndzip.launch`` inside it around each
kernel's launch (device guard, current stream, ctypes, the CUDA runtime's
memset and launch). They nest in the benchmark's ``portbench.*`` span of the
call, on the same host thread. ``tracing`` reads them as nothing; the
functions here read them.

The card's timestamps run ahead of the host's: on an H100 a kernel's start
read up to some 40 us before the host's launch of it (``tracing``). Placing
an operation by correlation id needs no common clock, but laying the card's
idle time against the host's spans does. The offset drifts through a
stretch, along a line: on an H100 by up to 7.3 us a ms either way, in 6 of
40 stretches (4,400 us over 0.6 s in one). A call's own lag, the most by
which one of its operations starts before its launch, is the offset less
that operation's wait on the card's queue; taken alone as the call's
shift, it would place a call of one operation exactly at its launch and
wipe out its wait. ``call_shifts`` fits one line to the calls' lags
instead: its slope the median of the slopes between calls half the
stretch apart (none under ``SLOPE_CALLS`` calls with a launch), its level the
largest lag less the slope's part, among those at most ``QUEUE`` above
their median. A lag above that is not the clock but a call whose
operations read early by themselves, and that call takes its own lag.
Each call's shift is the line's value at its start, at least its own lag
and at least 0. The readers place a call's operations at ``start + d`` on
the host's clock. Limits: the shortest wait of the stretch is taken as
nought; a call that reads early by ``QUEUE`` or less lifts the line for
every call; an offset below 0 (the card's clock late) is read as 0.

A ``tracing.Record`` carries what the readers need as two attributes,
``program_spans`` (``read_program_spans``) and ``call_shifts`` (seconds,
one a call), set by ``attach``; each reader returns None on a record
without them. ``per_call`` splits each call's time by what the host was
doing; the readers average it over a direction's calls.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass

from portbench import tracing

#: the prefix of the program's spans
PREFIX = "ndzip."
LAUNCH = "ndzip.launch"
#: the span of the codec's API call, by direction
API = {"compress": "ndzip.compress_device", "decompress": "ndzip.decompress_device"}
#: seconds: the most by which the line may place a call's earliest
#: operation after its launch; each call of the harness ends in a
#: synchronisation, so the queue is empty at its launch (medians of 6 to
#: 16 us and waits up to 65 us read on an H100)
QUEUE = 100e-6
#: the fewest calls with a launch from which the line takes a slope: between
#: a few calls the waits' spread, some 10 us, reads as a slope (a stretch
#: holds 500 calls or more)
SLOPE_CALLS = 100


def read_program_spans(events) -> list:
    """The program's spans (``ndzip.*``) of a chrome trace's events
    (``tracing.load_events``), as ``tracing.Span``, sorted by start."""
    spans = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            start = float(e["ts"]) * 1e-6
            spans.append(tracing.Span(e["name"], start, start + float(e.get("dur", 0)) * 1e-6))
    return sorted(spans, key=lambda s: s.start)


def clock_shift(ops) -> float:
    """Seconds ``d >= 0``: the most by which an operation's start on the
    card's clock lies before its launch on the host's, over the operations
    that have a launch; 0 where none does."""
    return max(0.0, _lag(ops) or 0.0)


def _lag(ops):
    """Seconds: the most by which an operation of ``ops`` starts before its
    launch (below 0 where each starts after it), or None where none has a
    launch."""
    lags = [o.launch - o.start for o in ops if o.launch is not None]
    return max(lags) if lags else None


def call_shifts(rec) -> list:
    """Seconds, one a call of ``rec``: the line fitted to the calls' lags
    at the call's start, at least the call's own lag and 0 (see the
    module's docstring)."""
    lags = [_lag(c.ops) for c in rec.calls]
    known = [(c.start, lag) for c, lag in zip(rec.calls, lags) if lag is not None]
    if not known:
        return [0.0] * len(rec.calls)
    slope = 0.0
    if len(known) >= SLOPE_CALLS:  # each call against the call half the stretch on
        slope = statistics.median((b - a) / (t - s) for (s, a), (t, b) in zip(known, known[len(known) // 2:]))
    t0 = known[0][0]
    rest = [lag - slope * (t - t0) for t, lag in known]
    level = max(r for r in rest if r <= statistics.median(rest) + QUEUE)
    return [max(0.0, level + slope * (c.start - t0), 0.0 if lag is None else lag) for c, lag in zip(rec.calls, lags)]


def attach(rec, program_spans):
    """Give ``rec`` the program's spans and each call's clock shift."""
    rec.program_spans = program_spans
    rec.call_shifts = call_shifts(rec)
    return rec


def shifted(rec, op) -> tuple[float, float]:
    """``op``'s start and end on the host's clock: shifted by its call's
    clock shift."""
    d = rec.call_shifts[op.call]
    return op.start + d, op.end + d


class _Merged:
    """Disjoint sorted intervals, with their starts for bisection."""

    def __init__(self, intervals):
        self.spans = tracing._union(intervals)
        self.starts = [s for s, _ in self.spans]

    def from_(self, lo: float):
        """The intervals in order from the last that starts at or before ``lo``."""
        for i in range(max(0, bisect.bisect_right(self.starts, lo) - 1), len(self.spans)):
            yield self.spans[i]

    def covered(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` that the intervals cover."""
        total = 0.0
        for s, e in self.from_(lo):
            if s >= hi:
                break
            total += max(0.0, min(e, hi) - max(s, lo))
        return total


def _by_call(rec) -> list:
    """The program's spans that lie inside each call of ``rec``, by the
    call's index."""
    starts = [c.start for c in rec.calls]
    out = [[] for _ in rec.calls]
    for s in rec.program_spans:
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and s.end <= rec.calls[i].end:
            out[i].append(s)
    return out


def _busy(rec) -> _Merged:
    """The card's busy intervals on the host's clock: every operation of the
    stretch shifted by its call's clock shift."""
    return _Merged(shifted(rec, o) for o in rec.ops)


@dataclass
class CallTimes:
    """One call's time by what the host was doing, in seconds."""

    direction: str
    span_s: float  # the benchmark's span of the call
    api_s: float  # the program's API span (``API``), 0 where the call has none
    launch_s: float  # inside ``ndzip.launch`` spans
    glue_s: float  # the API span less the ``ndzip.launch`` time inside it
    program_idle_s: float  # the card idle (shifted clock) while the host is inside a program span
    launches: int  # ``ndzip.launch`` spans


def per_call(rec):
    """``CallTimes`` of each call of ``rec``, or None where the record holds
    no program span."""
    if not getattr(rec, "program_spans", None):
        return None
    busy, out = _busy(rec), []
    for c, spans in zip(rec.calls, _by_call(rec)):
        launch = _Merged((s.start, s.end) for s in spans if s.name == LAUNCH)
        api = [s for s in spans if s.name == API[c.direction]]
        inside = tracing._union((s.start, s.end) for s in spans)
        out.append(CallTimes(
            c.direction, c.end - c.start, sum(s.end - s.start for s in api), launch.covered(c.start, c.end),
            sum(s.end - s.start - launch.covered(s.start, s.end) for s in api),
            sum(e - s - busy.covered(s, e) for s, e in inside), sum(s.name == LAUNCH for s in spans)))
    return out


def _of(rec, direction: str, keep):
    """The ``CallTimes`` of ``direction``'s calls, or None where no call of
    that direction has a span that ``keep`` accepts."""
    times = [t for t in per_call(rec) or () if t.direction == direction]
    return times if any(keep(t) for t in times) else None


def glue_us(rec, direction: str):
    """Mean per call of ``direction`` of the API span's self time, its
    ``ndzip.launch`` children left out, in us: checks, allocations, the
    path's choice."""
    times = _of(rec, direction, lambda t: t.api_s > 0)
    return None if times is None else 1e6 * sum(t.glue_s for t in times) / len(times)


def launch_us(rec, direction: str):
    """Mean per call of ``direction`` of the time inside ``ndzip.launch``
    spans, in us."""
    times = _of(rec, direction, lambda t: t.launches > 0)
    return None if times is None else 1e6 * sum(t.launch_s for t in times) / len(times)


def idle_in_program_pct(rec, direction: str):
    """Share of the calls' span time in which no operation runs on the card
    (shifted clock) while the host is inside a program span, in %."""
    times = _of(rec, direction, lambda t: t.span_s > 0)
    return None if times is None else 100.0 * sum(t.program_idle_s for t in times) / sum(t.span_s for t in times)


def _idle(busy: _Merged, lo: float, hi: float) -> list:
    """The gaps of ``busy`` inside ``[lo, hi]``."""
    gaps, at = [], lo
    for s, e in busy.from_(lo):
        if s >= hi:
            break
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def idle_by_host(rec):
    """The card's idle time inside the stretch's calls (shifted clock),
    summed by the innermost host span open at the time: a program span, or
    the call's ``portbench.*`` span outside every program span; as
    ``[[span, seconds], ...]``, longest first. None without program spans."""
    if not getattr(rec, "program_spans", None):
        return None
    busy, by_span = _busy(rec), {}
    for call, spans in zip(rec.calls, _by_call(rec)):
        cuts = sorted({t for s in spans for t in (s.start, s.end) if call.start < t < call.end})
        for lo, hi in _idle(busy, call.start, call.end):
            points = [lo] + [t for t in cuts if lo < t < hi] + [hi]
            for a, b in zip(points, points[1:]):
                mid = 0.5 * (a + b)
                open_ = [s for s in spans if s.start <= mid < s.end]
                name = (max(open_, key=lambda s: (s.start, -s.end)).name if open_
                        else tracing.SPAN_PREFIX + call.direction)
                by_span[name] = by_span.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by_span.items(), key=lambda kv: -kv[1])]


def idle_s(rec) -> float:
    """Seconds inside the stretch's calls in which no operation runs on the
    card (shifted clock): what ``idle_by_host`` divides."""
    busy = _busy(rec)
    return sum(c.end - c.start - busy.covered(c.start, c.end) for c in rec.calls)
