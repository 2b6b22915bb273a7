"""The benchmark's harness: one cell of ``BENCHMARK.json`` from set-up to the
judged result.

Everything that belongs to one configuration, traffic mix or metric lives in
a file of its own, found by its name:

* ``configs/<config>.json``: the field's shape, dtype, number of fields held
  and data formula (``make_fields``);
* ``traffic/<mix>.json``: the mix's parameters; its ``entry`` names the
  file ``entries/<entry>.py`` through which a call reaches the program; the
  loop is ``Run.sweep`` for all;
* ``endtoend/<metric>.py`` and ``metrics/<metric>.py``: a ``read`` function
  each, on the window's calls (``Run``) and on a traced stretch
  (``tracing.Record``).

A run: make the fields on the card from the seed, warm every shape the cell
uses, then for ``seconds`` sweep over the fields in turn, compress then
decompress each, one caller, closed loop. Each call is timed by two CUDA
events that bracket the host's call, recorded on an idle stream at its entry
and after the host holds its result, so they read the caller's time on the
card's clock. After the window, ``judge`` holds what the timed calls
produced to the plain reference (``reference/codec.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import statistics
import sys
import tempfile
import time
import traceback
from array import array
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from portbench import roofline, spans, tracing
from portbench.reference import codec as reference

PKG = Path(__file__).resolve().parent
#: modules that may not be loaded in a run, compared by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ndzip_tpu")
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: kernel names of the program's codec, whose launches ``codec_cuda.LAUNCHES`` counts
CODEC_KERNELS = ("encode_blocks", "decode_blocks")
TRACE_TRIES = 3


# ------------------------------------------------------------ registry


def _file(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = root / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} named {name!r}: {path} is missing")
    return path


def load_config(name: str, root: Path = PKG) -> dict:
    return json.loads(_file(root, "configs", name, ".json").read_text())


def load_mix(name: str, root: Path = PKG) -> dict:
    return json.loads(_file(root, "traffic", name, ".json").read_text())


def _module(folder: str, name: str, root: Path):
    path = _file(root, folder, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(folder: str, name: str, root: Path = PKG):
    """The ``read`` function of ``<root>/<folder>/<name>.py``."""
    return _module(folder, name, root).read


def load_entry(name: str, root: Path = PKG):
    """The ``Entry`` class of ``<root>/entries/<name>.py``: how a mix's
    calls reach the program. It is made with ``(program, config, device)``
    and has ``prepare(field)``, ``compress(x) -> (stream, length in u32
    words)`` and ``decompress(stream, like) -> field``, each returning once
    the caller holds the result."""
    return _module("entries", name, root).Entry


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``bench[section]`` that ``cell`` reports: those with no
    ``workloads`` key and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------ fields


def make_fields(cfg: dict, seed: int, device) -> list:
    """The configuration's fields on ``device``, from ``seed``: field k is
    the product over axes of ``fn(linspace(0, span, n) + phase[k, axis])``
    plus ``noise`` times N(0, 1), phases uniform in [0, 2 pi)."""
    shape, dtype = tuple(cfg["shape"]), getattr(torch, cfg["dtype"])
    axes, noise = cfg["formula"]["axes"], cfg["formula"]["noise"]
    if len(axes) != len(shape) or any(a["fn"] not in ("sin", "cos") for a in axes):
        raise ValueError(f"config {cfg['name']}: one sin or cos axis per dimension")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phases = torch.rand((cfg["fields"], len(axes)), generator=gen, device=device, dtype=torch.float64)
    phases = (phases * (2 * math.pi)).tolist()
    fields = []
    for k in range(cfg["fields"]):
        smooth = None
        for a, (axis, n) in enumerate(zip(axes, shape)):
            t = torch.linspace(0, axis["span"], n, device=device, dtype=torch.float64) + phases[k][a]
            v = getattr(torch, axis["fn"])(t).to(dtype).reshape([n if i == a else 1 for i in range(len(shape))])
            smooth = v if smooth is None else smooth * v
        fields.append(torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(noise).add_(smooth))
    return fields


def as_words(x, device) -> torch.Tensor:
    """The flat int32/int64 words of a tensor or numpy array, on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int64 if x.itemsize == 8 else np.int32))
    x = x.to(device).reshape(-1)
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


# ------------------------------------------------------------ entries


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ the window


class Clock:
    """A call's time: two CUDA events around it on the card, the second
    read once the host holds the result; the host's clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def time(self, fn, span=None):
        if not self.cuda:
            t0 = time.perf_counter()
            out = _spanned(fn, span)
            return out, time.perf_counter() - t0
        self.a.record()
        out = _spanned(fn, span)
        self.b.record()
        self.b.synchronize()
        return out, self.a.elapsed_time(self.b) * 1e-3


def _spanned(fn, span):
    if span is None:
        return fn()
    with torch.profiler.record_function(tracing.SPAN_PREFIX + span):
        return fn()


class Call(NamedTuple):
    direction: str
    field: int
    seconds: float
    in_bytes: int
    length_u32: int


DIRECTIONS = ("compress", "decompress")


@dataclass
class Run:
    """The window's calls and a sample of what they produced, drawn from
    the seed: per field, a uniform sample of ``keep`` of its (stream,
    field given back) pairs. The calls are kept in flat arrays, which the
    garbage collector does not scan, so that its pauses inside the timed
    calls do not grow with the window."""

    entry: object
    items: list
    likes: list
    clock: Clock
    keep: int
    rng: np.random.Generator
    samples: dict = field(default_factory=dict)
    seen: dict = field(default_factory=dict)
    failed: int = 0
    setup_s: float = 0.0

    def __post_init__(self):
        self.nbytes = [like.numel() * like.element_size() for like in self.likes]
        self.clear()

    def clear(self):
        self._dir, self._field, self._seconds, self._len = array("b"), array("l"), array("d"), array("q")

    def __len__(self):
        return len(self._seconds)

    def _record(self, d: int, f: int, seconds: float, n: int):
        self._dir.append(d)
        self._field.append(f)
        self._seconds.append(seconds)
        self._len.append(n)

    def calls_from(self, first: int = 0) -> list:
        """The calls made since the ``first``-th, as ``Call`` tuples."""
        return [Call(DIRECTIONS[d], f, t, self.nbytes[f], n) for d, f, t, n in
                zip(self._dir[first:], self._field[first:], self._seconds[first:], self._len[first:])]

    @property
    def calls(self) -> list:
        return self.calls_from(0)

    def lengths(self, f: int) -> np.ndarray:
        """The lengths the compress calls of field ``f`` gave."""
        d, fs = np.frombuffer(self._dir, np.int8), np.frombuffer(self._field, np.int64)
        return np.frombuffer(self._len, np.int64)[(d == 0) & (fs == f)]

    def sweep(self, spans: bool = False):
        """Each field in turn: compress, then decompress its stream."""
        for f, (x, like) in enumerate(zip(self.items, self.likes)):
            (stream, n), t = self.clock.time(lambda: self.entry.compress(x), "compress" if spans else None)
            self._record(0, f, t, n)
            out, t = self.clock.time(lambda: self.entry.decompress(stream, like), "decompress" if spans else None)
            self._record(1, f, t, n)
            self._sample(f, stream, out)

    def _sample(self, f, stream, out):
        i = self.seen.get(f, 0)
        self.seen[f] = i + 1
        slots = self.samples.setdefault(f, [])
        if len(slots) < self.keep:
            slots.append((stream, out))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.keep:
                slots[j] = (stream, out)


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc, 10 ms ticks)."""
    import os

    start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    return float(Path("/proc/uptime").read_text().split()[0]) - start_ticks / os.sysconf("SC_CLK_TCK")


# ------------------------------------------------------------ judging


def _differing(a: torch.Tensor, b: torch.Tensor) -> int:
    n = min(a.numel(), b.numel())
    return int((a[:n] != b[:n]).sum()) + abs(a.numel() - b.numel())


def judge(run: Run, fields: list, device) -> dict:
    """Hold what the window produced to the plain reference: the length of
    every compress call, and each sampled stream and field given back, word
    for word. Returns the numbers compared, each with its limit."""
    lengths = stream_words = field_words = unchecked = 0
    for f, x in enumerate(fields):
        words = as_words(x, device).reshape(x.shape)
        ref_stream, ref_len = reference.encode(words)
        ref_len = int(ref_len)
        ref = ref_stream[:ref_len]
        lengths += int((run.lengths(f) != ref_len).sum())
        slots = run.samples.get(f, [])
        unchecked += not slots
        for stream, out in slots:
            stream_words += _differing(as_words(stream, device), ref)
            field_words += _differing(as_words(out, device), words.reshape(-1))
        del ref_stream, ref
    return {"length_mismatches": [lengths, 0], "stream_words_differing": [stream_words, 0],
            "field_words_differing": [field_words, 0], "fields_unchecked": [unchecked, 0]}


# ------------------------------------------------------------ tracing


def read_record(path, calls, peak) -> tracing.Record:
    """The ``tracing.Record`` of the chrome trace at ``path`` for ``calls``
    (``(direction, bound_bytes)`` in order), with the launches whose
    operation the trace lost counted (``tracing.launches_without_op``) and
    the program's spans and each call's clock shift attached
    (``spans.attach``); the file is parsed once."""
    events = tracing.load_events(path)
    rec = tracing.build_record(*tracing.read_events(events), calls, peak)
    rec.launches_without_op = tracing.launches_without_op(events)
    return spans.attach(rec, spans.read_program_spans(events))


def profile_sweeps(run: Run, sweeps: int):
    """``sweeps`` sweeps of the window with the benchmark's spans, under
    ``torch.profiler``; the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if run.clock.cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(sweeps):
            run.sweep(spans=True)
    return prof


def read_profile(prof, run: Run, first: int, peak, keep=None) -> tracing.Record:
    """``read_record`` of ``prof``'s trace for the calls of ``run`` from the
    ``first``-th on; ``keep(path)``, where given, sees the exported trace
    before it is deleted."""
    word = run.likes[0].element_size()
    calls = [(c.direction, roofline.codec_bytes(c.in_bytes // word, word, c.length_u32)) for c in run.calls_from(first)]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        if keep is not None:
            keep(path)
        return read_record(path, calls, peak)


def _traced_stretch(run: Run, program, sweeps: int, peak):
    """Profile ``sweeps`` sweeps of the window; the ``tracing.Record`` and
    whether the codec's kernels in the trace match ``codec_cuda.LAUNCHES``."""
    counter = getattr(getattr(program, "codec_cuda", None), "LAUNCHES", None)
    before = sum(counter.values()) if counter is not None else None
    first = len(run)
    rec = read_profile(profile_sweeps(run, sweeps), run, first, peak)
    kernels = sum(any(k in o.name for k in CODEC_KERNELS) for o in rec.ops)
    launched = sum(counter.values()) - before if counter is not None else kernels
    return rec, kernels == launched, (kernels, launched)


def traced_device(rec: tracing.Record) -> dict:
    """What the traced line adds to ``device``: ``busy_s`` and ``window_s``
    (``tracing.busy_and_window``), ``clock_shift_us`` (the median and the
    most over the calls of ``spans.call_shifts``), ``ops_without_launch``
    and ``launches_without_op``."""
    busy, window = tracing.busy_and_window(rec)
    shifts = rec.call_shifts or [0.0]
    return {"busy_s": busy, "window_s": window,
            "clock_shift_us": {"median": 1e6 * statistics.median(shifts), "max": 1e6 * max(shifts)},
            "ops_without_launch": rec.ops_without_launch, "launches_without_op": rec.launches_without_op}


def traced_breakdown(rec: tracing.Record) -> dict:
    """``tracing.breakdown`` and, where the program's spans are there,
    ``idle_by_host`` (``spans.idle_by_host``)."""
    out = tracing.breakdown(rec)
    by_host = spans.idle_by_host(rec)
    if by_host is not None:
        out["idle_by_host"] = by_host
    return out


def queued_kernel_seconds(program, likes, items, device, direction: str) -> float:
    """The device time of the codec's own launches for one call on each
    field, by CUDA events with the launches queued behind a spin kernel (so
    that the host's enqueue stays out): the stand-in where the profiler lost
    records."""
    total = 0.0
    for like, x in zip(likes, items):
        words = as_words(x, device).reshape(like.shape).view(like.dtype)
        stream, length = program.compress_device(words)
        stream = stream[: int(length)]
        fn = ((lambda: program.compress_device(words)) if direction == "compress"
              else (lambda: program.decompress_device(stream, like.shape, like.dtype)))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 24)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b) * 1e-3
    return total


# ------------------------------------------------------------ a cell


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    ratio: float
    breakdown: dict | None = None
    notes: list = field(default_factory=list)
    record: tracing.Record | None = None  # the traced stretch's, with ``--trace 1``


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device, program,
             root: Path = PKG, entry_factory=None) -> Result:
    """Run one cell on ``device`` with ``program`` (the package under test)
    and judge it. ``entry_factory`` (tests, the control) replaces the
    mix's entry."""
    device = torch.device(device)
    cfg, mix = load_config(cell["config"], root), load_mix(cell["traffic"], root)
    readers = {m["name"]: (m, load_reader("metrics" if trace else "endtoend", m["name"], root))
               for m in cell_metrics(bench, "per_layer" if trace else "end_to_end", cell["name"])}
    entry = (entry_factory or load_entry(mix["entry"], root))(program, cfg, device)
    fields = make_fields(cfg, seed, device)
    items = [entry.prepare(x) for x in fields]
    likes = [torch.empty((), dtype=x.dtype).expand(x.shape) for x in fields]  # shape and dtype alone
    if not isinstance(items[0], torch.Tensor):  # the host holds the fields; the reference reads them there
        fields = items
    sync(device)
    rng = np.random.default_rng([seed, 1])
    run = Run(entry, items, likes, Clock(device), mix["sample_per_field"], rng)
    notes, record = [], None
    try:
        # every shape, the card's clocks up, and the allocator's blocks for the samples held
        warm_end, sweeps = time.perf_counter() + mix["warm_seconds"], 0
        while sweeps < mix["warm_sweeps"] or time.perf_counter() < warm_end:
            run.sweep()
            sweeps += 1
        run.clear()
        run.samples.clear()
        run.seen.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        sync(device)
        gc.collect()
        gc.freeze()  # what set-up made is not scanned again by the collections inside the window
        run.setup_s = process_age_s()
        t_end = time.perf_counter() + seconds
        t0 = time.perf_counter()
        run.sweep()
        sweep_s = time.perf_counter() - t0
        if trace:
            sweeps = max(1, math.ceil(mix["trace_seconds"] / max(sweep_s, 1e-9)))
            peak = roofline.peak_bytes_per_s(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
            for attempt in range(TRACE_TRIES):
                record, agree, (kernels, launched) = _traced_stretch(run, program, sweeps, peak)
                if agree:
                    break
                notes.append(f"trace {attempt + 1}: {kernels} codec kernels, LAUNCHES counted {launched}")
            else:
                record.kernel_seconds = {d: queued_kernel_seconds(program, likes, items, device, d)
                                         * sum(c.direction == d for c in record.calls) / len(items)
                                         for d in ("compress", "decompress")}
                notes.append("the codec's kernel time taken by queued CUDA events instead")
        while time.perf_counter() < t_end:
            run.sweep()
    except Exception:  # a failed call ends the window; the run is judged not correct
        run.failed += 1
        traceback.print_exc()
    gc.unfreeze()
    attempted = len(run) + run.failed
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del entry, run.entry
    checks = judge(run, fields, device)
    correct = run.failed == 0 and all(v <= lim for v, lim in checks.values())
    metrics, dev = {}, {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                        "count": cell["chips"], "memory_peak_bytes": peak_bytes}
    out_breakdown = None
    if trace and record is not None:
        dev.update(traced_device(record))
        out_breakdown = traced_breakdown(record)
    for name, (m, read) in readers.items():  # a reader that finds nothing returns None: the metric is left out
        value = read(record if trace else run) if not trace or record is not None else None
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    comp = [c for c in run.calls if c.direction == "compress"]
    ratio = (sum(4 * c.length_u32 for c in comp) / sum(c.in_bytes for c in comp)) if comp else float("nan")
    return Result(correct, attempted, run.failed, metrics, dev,
                  {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}, ratio, out_breakdown, notes,
                  record)
