"""Trace one cell with the program's spans and print what they show:

    python3 portbench/trace_spans.py --workload <name> --seed <n> [--stretches 3] [--out DIR]

from the root of a checkout, on the card. It sets the cell up as ``run.py``
does (the fields from the seed, the warm sweeps), then runs ``--stretches``
pairs of stretches of the mix's ``trace_seconds`` each, whole sweeps, one
caller: an untraced one, with no span, as the window runs, then a traced one
under ``torch.profiler`` with the benchmark's and the program's spans. Each
traced stretch is read into a record as ``run.py --trace 1`` reads its own
(``harness.read_profile``), and gives the per-layer metrics of ``metrics/``
(those ``tracing`` reads and those ``spans`` reads) and what the traced line
adds to ``device`` and ``breakdown``. Beyond ``run.py``, the tool gives the
calls per second of both stretches (what tracing costs while on), checks
per call that the spans nest as ``spans`` reads them, times a span with
no profiler (``span_cost_us``), and splits a call's host time untraced, by
the spans' own cuts, with no profiler and no span (``host_split_us``).
Last it judges the calls' outputs against the plain reference as
``run.py`` does. ``--out DIR`` writes the first
traced stretch's calls ``--skip`` to ``--skip + --keep`` as a chrome trace
(``DIR/<workload>_spans.json``), the events of those calls alone.

The last line on stdout is one JSON object. It exits nonzero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout: the program and the benchmark as packages

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, roofline, spans, tracing  # noqa: E402

#: the per-layer readers of ``metrics/`` read on each traced stretch
METRICS = tuple(f"{m}.{d}" for m in ("glue_us", "launch_us", "idle_in_program_pct", "device_idle_pct",
                                     "kernel_roofline_pct", "device_ops_per_call")
                for d in harness.DIRECTIONS)
#: slack of the checks per call, seconds: the trace's timestamps are whole nanoseconds
EPS = 1e-8


def _sweeps(run, sweeps: int, traced: bool):
    """``(first call, calls, seconds, profiler or None)`` of ``sweeps`` sweeps."""
    first, prof = len(run), None
    t0 = time.perf_counter()
    if traced:
        prof = harness.profile_sweeps(run, sweeps)
    else:
        for _ in range(sweeps):
            run.sweep()
    return first, len(run) - first, time.perf_counter() - t0, prof


def cut(src: Path, dst: Path, skip: int, keep: int):
    """Write the benchmark's calls ``skip`` to ``skip + keep`` of the chrome
    trace ``src`` to ``dst``: the host's events inside those calls' spans and
    the card's operations and flows their launches correlate with."""
    data = json.loads(src.read_text())
    events = data["traceEvents"]
    calls = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(tracing.SPAN_PREFIX)), key=lambda e: e["ts"])[skip:skip + keep]
    lo, hi = calls[0]["ts"], calls[-1]["ts"] + calls[-1]["dur"]
    host = [e for e in events if e.get("ph") in ("X", "s") and e.get("cat") not in tracing.DEVICE_CATS
            and e.get("cat") != "ac2g" and lo <= e.get("ts", -1) <= hi]
    corr = {(e.get("args") or {}).get("correlation") for e in host} - {None}
    flows = [e for e in events if e.get("cat") == "ac2g" and e.get("id") in corr]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in tracing.DEVICE_CATS
              and (e.get("args") or {}).get("correlation") in corr]
    meta = [e for e in events if e.get("ph") == "M"]
    data["traceEvents"] = meta + sorted(host + device + flows, key=lambda e: e["ts"])
    data["traceName"] = dst.name
    dst.write_text(json.dumps(data))


def call_checks(rec) -> dict:
    """Per call of ``rec`` (with the program's spans): the glue and launch
    time against the API span, and the program's idle share against the
    card's (``tracing.idle_pct`` of the call alone). Counts the calls that
    break each, and the operations that start before their launch on the
    shifted clock."""
    late = sum(o.launch is not None and spans.shifted(rec, o)[0] < o.launch - EPS for o in rec.ops)
    over = idle = 0
    for c, t in zip(rec.calls, spans.per_call(rec) or ()):
        over += t.api_s > 0 and t.glue_s + t.launch_s > t.api_s + EPS
        own = tracing.Record([c], c.ops, rec.window, rec.peak_bytes_per_s)
        idle += 100.0 * t.program_idle_s / t.span_s > tracing.idle_pct(own, c.direction) + 1e-6
    return {"ops_before_launch": late, "calls_glue_and_launch_over_span": over,
            "calls_idle_in_program_over_device_idle": idle, "calls": len(rec.calls)}


def read_stretch(run, prof, first: int, peak, out: Path | None, skip: int, keep: int) -> dict:
    """The readings of one traced stretch."""
    def keep_calls(path):
        out.parent.mkdir(parents=True, exist_ok=True)
        cut(path, out, skip, keep)

    rec = harness.read_profile(prof, run, first, peak, None if out is None else keep_calls)
    kernels = sum(any(k in o.name for k in harness.CODEC_KERNELS) for o in rec.ops)
    metrics = {}
    for name in METRICS:
        value = harness.load_reader("metrics", name)(rec)
        if value is not None:
            metrics[name] = value
    lags = sorted((o.start - o.launch, o.name, o.launch - rec.window[0]) for o in rec.ops if o.launch is not None)
    return {"metrics": metrics, **harness.traced_device(rec),
            # the card's start less the host's launch, unshifted: the least sets the largest call's shift
            "start_after_launch_us": [1e6 * lags[k][0] for k in (0, 1, len(lags) // 2, -1)] if lags else None,
            "shift_set_by": [lags[0][1][:48], lags[0][2]] if lags else None,
            "idle_s": spans.idle_s(rec), "program_spans": len(rec.program_spans), "codec_kernels": kernels,
            "checks": call_checks(rec), "breakdown": harness.traced_breakdown(rec)}


def host_split_us(run, program, sweeps: int) -> dict | None:
    """Host us a call of each direction spends through ``sweeps`` untraced
    sweeps, where the spans would cut it: ``call`` in the entry's call (the
    benchmark's span), ``api`` in ``codec_cuda.compress_device`` or
    ``decompress_device`` (the API span), ``launch`` in ``codec_cuda._launch``
    (the ``ndzip.launch`` spans) and ``glue``, the API less its launches;
    with ``calls``, and ``calls_per_s``. Timed by ``time.perf_counter``
    wrapped around those functions for the sweeps, no profiler recording;
    ``timer_us`` is what one wrapper adds to a call. None where the program
    has no ``codec_cuda``."""
    cc = getattr(program, "codec_cuda", None)
    if cc is None:
        return None
    total = {d: {"call": 0.0, "api": 0.0, "launch": 0.0, "calls": 0} for d in harness.DIRECTIONS}
    now = [harness.DIRECTIONS[0]]

    def timed(fn, key, direction=None):
        def call(*args, **kwargs):
            if direction is not None:
                now[0] = direction
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                total[now[0]][key] += time.perf_counter() - t0
                total[now[0]]["calls"] += key == "call"
        return call

    places = [(cc, "_launch", "launch", None)] + [(cc, f"{d}_device", "api", d) for d in harness.DIRECTIONS] \
        + [(run.entry, d, "call", d) for d in harness.DIRECTIONS]
    saved = [getattr(obj, name) for obj, name, _, _ in places]
    try:
        for (obj, name, key, direction), fn in zip(places, saved):
            setattr(obj, name, timed(fn, key, direction))
        t0 = time.perf_counter()
        for _ in range(sweeps):
            run.sweep()
        seconds = time.perf_counter() - t0
    finally:
        for (obj, name, _, _), fn in zip(places, saved):
            if obj is run.entry:
                delattr(obj, name)  # the entry's methods were its class's
            else:
                setattr(obj, name, fn)
    out = {}
    for d, t in total.items():
        n = max(t["calls"], 1)
        out[d] = {k: 1e6 * t[k] / n for k in ("call", "api", "launch")}
        out[d].update(glue=out[d]["api"] - out[d]["launch"], calls=t["calls"])
    bare = timed(lambda: None, "launch")
    out["calls_per_s"] = sum(t["calls"] for t in total.values()) / seconds
    out["timer_us"] = 1e6 * (min(timeit.repeat(bare, number=20_000, repeat=5))
                             - min(timeit.repeat(lambda: None, number=20_000, repeat=5))) / 20_000
    return out


def span_cost_us(n: int = 100_000) -> dict:
    """Host microseconds a span costs with no profiler: ``utils.trace`` and
    an idle ``record_function``, best of five runs of ``n``."""
    from ndzip_tpu_torch import utils

    def trace():
        with utils.trace("ndzip.cost"):
            pass

    def record_function():
        with torch.profiler.record_function("ndzip.cost"):
            pass

    return {f.__name__: 1e6 * min(timeit.repeat(f, number=n, repeat=5)) / n for f in (trace, record_function)}


def trace_cell(cell: dict, seed: int, device, program, stretches: int = 3, out: Path | None = None,
               skip: int = 4, keep: int = 6, root: Path = harness.PKG) -> dict:
    """Set ``cell`` up, run ``stretches`` untraced and traced stretches and
    return their readings (see the module's docstring)."""
    device = torch.device(device)
    cfg, mix = harness.load_config(cell["config"], root), harness.load_mix(cell["traffic"], root)
    entry = harness.load_entry(mix["entry"], root)(program, cfg, device)
    fields = harness.make_fields(cfg, seed, device)
    items = [entry.prepare(x) for x in fields]
    likes = [torch.empty((), dtype=x.dtype).expand(x.shape) for x in fields]
    if not isinstance(items[0], torch.Tensor):
        fields = items
    run = harness.Run(entry, items, likes, harness.Clock(device), mix["sample_per_field"],
                      np.random.default_rng([seed, 1]))
    warm_end, n = time.perf_counter() + mix["warm_seconds"], 0
    while n < mix["warm_sweeps"] or time.perf_counter() < warm_end:
        run.sweep()
        n += 1
    t0 = time.perf_counter()
    run.sweep()
    sweeps = max(1, math.ceil(mix["trace_seconds"] / max(time.perf_counter() - t0, 1e-9)))
    peak = roofline.peak_bytes_per_s(torch.cuda.get_device_name(device)) if device.type == "cuda" else None
    counter = getattr(getattr(program, "codec_cuda", None), "LAUNCHES", None)
    out_file = None if out is None else Path(out) / f"{cell['name']}_spans.json"
    readings = []
    for i in range(stretches):
        _, plain_calls, plain_s, _ = _sweeps(run, sweeps, traced=False)
        before = sum(counter.values()) if counter is not None else None
        first, calls, seconds, prof = _sweeps(run, sweeps, traced=True)
        r = read_stretch(run, prof, first, peak, out_file if i == 0 else None, skip, keep)
        r["launches_counted"] = sum(counter.values()) - before if counter is not None else None
        r["calls_per_s"] = {"untraced": plain_calls / plain_s, "traced": calls / seconds}
        r["tracing_cost_pct"] = 100.0 * (1.0 - r["calls_per_s"]["traced"] / r["calls_per_s"]["untraced"])
        readings.append(r)
    split = host_split_us(run, program, sweeps)
    del entry, run.entry
    checks = harness.judge(run, fields, device)
    return {"workload": cell["name"], "seed": seed, "sweeps_a_stretch": sweeps, "stretches": readings,
            "host_split_us": split,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--stretches", type=int, default=3)
    p.add_argument("--out", type=Path)
    p.add_argument("--skip", type=int, default=4)
    p.add_argument("--keep", type=int, default=6)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; the workloads are {sorted(cells)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(2)

    import ndzip_tpu_torch

    result = trace_cell(cells[args.workload], args.seed, torch.device("cuda", 0), ndzip_tpu_torch,
                        args.stretches, args.out, args.skip, args.keep)
    result["device"] = torch.cuda.get_device_name(0)
    result["span_cost_us"] = span_cost_us()
    if harness.forbidden_modules():
        print(f"modules that the run may not load were loaded: {harness.forbidden_modules()}", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
