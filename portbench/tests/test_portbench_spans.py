"""The readers of the program's spans (``spans``) and the tool that traces a
cell with them (``trace_spans``): on a chrome trace written as
``torch.profiler`` writes one, with a known skew of the card's clock, on
the H100 traces under ``data/``, and on the CPU through the harness."""

import dataclasses
import json
import types
from pathlib import Path

import pytest

import ndzip_tpu_torch
from portbench import harness, spans, trace_spans, tracing

US = 1e-6
DATA = Path(__file__).parent / "data"
#: the card's clock against the host's in ``_trace``: a start reads 40 us early
SKEW = 40.0


def _read(path):
    """``(spans, ops)`` of the chrome trace at ``path``."""
    return tracing.read_events(tracing.load_events(path))


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1, "ts": ts, "dur": dur, "args": args}


def _trace(tmp_path, skew=SKEW):
    """Two calls, host times in us. compress [100, 200]: ndzip.compress_device
    [102, 150] holding ndzip.launch [120, 140], which launches a memset at
    122 and the kernel at 130; the length's copy launched at 160, outside
    the program. On the card, on the host's clock: memset 122-124 (it starts
    as it is launched), kernel 135-175, copy 180-181. decompress [250, 330]:
    ndzip.decompress_device [255, 290] holding ndzip.launch [270, 285],
    which launches the decode at 275; it runs 280-320. The card's
    timestamps read ``skew`` us early. The compress call's own shift is
    ``skew`` (its memset starts as it is launched); the decompress call's
    alone would be ``skew`` - 5, which would place the decode at its
    launch, and it takes its neighbour's, ``skew``, which keeps its 5 us
    on the card's queue."""
    card = lambda t: t - skew  # noqa: E731
    events = [
        _x("user_annotation", "portbench.compress", 100, 100),
        _x("user_annotation", "ndzip.compress_device", 102, 48),
        _x("user_annotation", "ndzip.launch", 120, 20),
        _x("cuda_runtime", "cudaMemsetAsync", 122, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 130, 5, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 160, 3, correlation=3),
        _x("gpu_memset", "Memset (Device)", card(122), 2, correlation=1),
        _x("kernel", "void encode_blocks_nd<2>(...)", card(135), 40, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", card(180), 1, correlation=3),
        _x("user_annotation", "portbench.decompress", 250, 80),
        _x("user_annotation", "ndzip.decompress_device", 255, 35),
        _x("user_annotation", "ndzip.launch", 270, 15),
        _x("cuda_runtime", "cudaLaunchKernel", 275, 3, correlation=9),
        _x("kernel", "void decode_blocks_nd<2>(...)", card(280), 40, correlation=9),
        _x("user_annotation", "other span", 250, 80),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def _record(path, calls):
    return harness.read_record(path, calls, 3.35e12)


@pytest.fixture
def rec(tmp_path):
    return _record(_trace(tmp_path), [("compress", 670_000), ("decompress", 670_000)])


def test_the_program_spans_are_read_and_the_benchmark_reads_them_as_nothing(tmp_path):
    path = _trace(tmp_path)
    assert [s.name for s in spans.read_program_spans(tracing.load_events(path))] == [
        "ndzip.compress_device", "ndzip.launch", "ndzip.decompress_device", "ndzip.launch"]
    assert [s.name for s in _read(path)[0]] == ["portbench.compress", "portbench.decompress"]


@pytest.mark.parametrize("skew, shift", [(SKEW, SKEW), (0.0, 0.0), (-30.0, 0.0)],
                         ids=["card-early", "aligned", "card-late"])
def test_the_clock_shift_is_the_skew_that_puts_each_operation_after_its_launch(tmp_path, skew, shift):
    _, ops = _read(_trace(tmp_path, skew))
    assert spans.clock_shift(ops) == pytest.approx(shift * US)
    d = spans.clock_shift(ops)
    assert all(o.start + d >= o.launch - 1e-12 for o in ops)
    assert spans.clock_shift([]) == 0.0


def test_the_readers_give_the_hand_computed_values(rec):
    # compress: API 48 us, launch 20 inside it; the host in a program span
    # while the card idles: [102, 150] less memset 122-124 and kernel 135-150
    assert spans.glue_us(rec, "compress") == pytest.approx(28)
    assert spans.launch_us(rec, "compress") == pytest.approx(20)
    assert spans.idle_in_program_pct(rec, "compress") == pytest.approx(31.0)
    # decompress: API 35, launch 15; [255, 290] less the decode's 280-290, over 80
    assert spans.glue_us(rec, "decompress") == pytest.approx(20)
    assert spans.launch_us(rec, "decompress") == pytest.approx(15)
    assert spans.idle_in_program_pct(rec, "decompress") == pytest.approx(100 * 25 / 80)
    for name, value in [("glue_us.compress", 28), ("launch_us.decompress", 15),
                        ("idle_in_program_pct.decompress", 31.25)]:
        assert harness.load_reader("metrics", name)(rec) == pytest.approx(value)


def test_idle_by_host_names_the_innermost_span_and_sums_to_the_idle_time(rec):
    by = spans.idle_by_host(rec)
    assert {n: round(s / US, 6) for n, s in by} == {
        "portbench.compress": 26, "ndzip.launch": 23, "ndzip.compress_device": 18,
        "portbench.decompress": 15, "ndzip.decompress_device": 15}
    assert [s for _, s in by] == sorted((s for _, s in by), reverse=True)
    assert sum(s for _, s in by) == pytest.approx(spans.idle_s(rec)) == pytest.approx(97 * US)
    assert json.loads(json.dumps(by)) == by


def test_each_call_splits_into_glue_and_launch_within_its_span(rec):
    times = spans.per_call(rec)
    assert [t.direction for t in times] == ["compress", "decompress"]
    for t, (api, launch, idle) in zip(times, [(48, 20, 31), (35, 15, 25)]):
        assert (t.api_s / US, t.launch_s / US, t.program_idle_s / US) == pytest.approx((api, launch, idle))
        assert t.glue_s + t.launch_s == pytest.approx(t.api_s) and t.launches == 1
    for d in ("compress", "decompress"):
        assert spans.idle_in_program_pct(rec, d) <= tracing.idle_pct(rec, d)


def _bare(tmp_path):
    """``_trace`` without the program's spans, as the parent program writes it."""
    path = tmp_path / "bare.json"
    events = [e for e in json.loads(_trace(tmp_path).read_text())["traceEvents"] if not e["name"].startswith("ndzip.")]
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_without_program_spans_every_reader_finds_nothing(tmp_path):
    path = _bare(tmp_path)
    rec = _record(path, [("compress", 1), ("decompress", 1)])
    bare = tracing.build_record(*_read(path), [("compress", 1), ("decompress", 1)], None)
    for r in (rec, bare):  # spans attached but none there; nothing attached at all
        for d in ("compress", "decompress"):
            assert spans.glue_us(r, d) is spans.launch_us(r, d) is spans.idle_in_program_pct(r, d) is None
        assert spans.idle_by_host(r) is None and spans.per_call(r) is None


def test_the_existing_readers_read_the_same_with_program_spans(tmp_path, rec):
    """``tracing`` reads a trace with the program's spans as one without."""
    bare = tracing.build_record(*_read(_bare(tmp_path)), [("compress", 670_000), ("decompress", 670_000)],
                                3.35e12)
    for d in ("compress", "decompress"):
        for f in (tracing.roofline_pct, tracing.idle_pct, tracing.copy_pct, tracing.ops_per_call):
            assert f(rec, d) == f(bare, d)
    assert tracing.busy_and_window(rec) == tracing.busy_and_window(bare)
    assert tracing.breakdown(rec) == tracing.breakdown(bare)


CESM_CALL = 6_480_000 * 4 + 4 * 4_360_000


def test_the_trace_without_program_spans_reads_as_before():
    """``data/h100_cesm_trace.json`` (no program span) reads what it read
    before the program had spans; its card ran 40.1 us ahead of the host."""
    path = DATA / "h100_cesm_trace.json"
    host, ops = _read(path)
    rec = tracing.build_record(host, ops, [("compress", CESM_CALL), ("decompress", CESM_CALL)] * 2, 3.35e12)
    expected = {"compress": (29.92841301878009, 96.66146621000316, 0.1889849681876858, 3.0),
                "decompress": (49.202741717089985, 90.78427110271696, None, 1.0)}
    for d, (roof, idle, copy, per_call) in expected.items():
        assert tracing.roofline_pct(rec, d) == pytest.approx(roof, rel=1e-12)
        assert tracing.idle_pct(rec, d) == pytest.approx(idle, rel=1e-12)
        assert tracing.copy_pct(rec, d) == (copy if copy is None else pytest.approx(copy, rel=1e-12))
        assert tracing.ops_per_call(rec, d) == per_call
    assert tracing.busy_and_window(rec) == pytest.approx((0.00014429702423512936, 0.0033935450483113527), rel=1e-12)
    b = tracing.breakdown(rec)
    assert [n for n, _ in b["idle_gaps"]] == ["between portbench.compress and portbench.decompress",
                                              "between portbench.decompress and portbench.compress",
                                              "portbench.compress",
                                              "between portbench.compress and portbench.decompress"] + [
                                                 "portbench.compress"] * 3
    assert [s for _, s in b["idle_gaps"]] == pytest.approx(
        [0.0005487552843987942, 0.00021892786026000977, 0.0001433948054909706, 0.00013585109263658524,
         2.5371089577674866e-05, 8.412869647145271e-06, 2.9990915209054947e-06], rel=1e-12)
    assert [s for _, s in b["device_ops"]] == pytest.approx(
        [8.410890586674213e-05, 5.261204205453396e-05, 5.190027877688408e-06, 2.386048436164856e-06], rel=1e-12)
    # the card ran ahead of the host: encode_blocks_nd<2> started 40.13 us before its launch
    assert spans.clock_shift(ops) / US == pytest.approx(40.12789577245712, rel=1e-9)
    spans.attach(rec, spans.read_program_spans(tracing.load_events(path)))
    assert rec.program_spans == [] and spans.idle_by_host(rec) is None
    assert max(rec.call_shifts) / US == pytest.approx(40.12789577245712, rel=1e-9)


def test_the_tool_traces_a_cell_on_the_cpu(bench, tiny_root, tmp_path):
    """The plain versions on the CPU open no program span: the tool runs,
    the spans' readers find nothing, the calls are judged, and the cut
    trace holds the kept calls."""
    cell = next(c for c in bench["workloads"] if c["name"] == "cesm.fields")
    mix = tiny_root / "traffic" / "device.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), trace_seconds=0.05)))
    r = trace_spans.trace_cell(cell, 2**31 + 11, "cpu", ndzip_tpu_torch, stretches=2, out=tmp_path, skip=1, keep=3,
                               root=tiny_root)
    assert r["correct"] and len(r["stretches"]) == 2
    for s in r["stretches"]:
        assert s["program_spans"] == 0 and s["clock_shift_us"] == {"median": 0.0, "max": 0.0}
        assert "idle_by_host" not in s["breakdown"] and s["ops_without_launch"] == 0
        assert not {"glue_us.compress", "launch_us.decompress"} & set(s["metrics"])
        assert s["calls_per_s"]["untraced"] > 0 and s["calls_per_s"]["traced"] > 0
    split = r["host_split_us"]  # on the CPU no call reaches codec_cuda
    for d in ("compress", "decompress"):
        assert split[d]["calls"] > 0 and split[d]["call"] > 0 and split[d]["api"] == split[d]["launch"] == 0
    assert split["calls_per_s"] > 0 and split["timer_us"] < 5
    cut = json.loads((tmp_path / "cesm.fields_spans.json").read_text())
    names = [e["name"] for e in cut["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names == ["portbench.decompress", "portbench.compress", "portbench.decompress"]


def test_a_trace_with_program_spans_recorded_on_the_card():
    """Calls 4-9 of a traced ``cesm.fields`` stretch with the program's
    spans (NVIDIA H100 80GB HBM3, 700 W; ``trace_spans --out``): after the
    shift no operation starts before its launch, each call's glue and launch
    fit in its API span, and the card idles no more while the host is in
    the program than in the whole call."""
    path = DATA / "h100_cesm_trace_spans.json"
    host, ops = _read(path)
    assert [s.name for s in host] == ["portbench.compress", "portbench.decompress"] * 3
    rec = _record(path, [(s.name.split(".", 1)[1], CESM_CALL) for s in host])
    assert all(spans.shifted(rec, o)[0] >= o.launch for o in rec.ops if o.launch is not None)
    for c, call_spans, t in zip(rec.calls, spans._by_call(rec), spans.per_call(rec)):
        api = [s for s in call_spans if s.name == spans.API[c.direction]]
        launch = [s for s in call_spans if s.name == spans.LAUNCH]
        assert len(api) == 1 and len(launch) == 1 and len(call_spans) == 2
        assert api[0].start <= launch[0].start and launch[0].end <= api[0].end
        assert 0 < t.glue_s and 0 < t.launch_s and t.glue_s + t.launch_s <= t.api_s + 1e-9 and t.api_s < t.span_s
        own = tracing.Record([c], c.ops, rec.window, rec.peak_bytes_per_s)
        assert 0 < 100 * t.program_idle_s / t.span_s <= tracing.idle_pct(own, c.direction)
    for d in ("compress", "decompress"):
        assert 0 < spans.idle_in_program_pct(rec, d) <= tracing.idle_pct(rec, d)
        assert spans.glue_us(rec, d) > 0 and spans.launch_us(rec, d) > 0
    by = dict(spans.idle_by_host(rec))
    assert set(by) == {"ndzip.launch", "ndzip.compress_device", "ndzip.decompress_device",
                       "portbench.compress", "portbench.decompress"}
    assert sum(by.values()) == pytest.approx(spans.idle_s(rec))


#: host us between the calls of ``_calls``: far enough that no call's misplaced operation reaches the next
APART = 1000.0


def _calls(tmp_path, early, without_launches=()):
    """Compress calls, each ``_trace``'s with host times ``APART`` us a call
    later, one for each of ``early``. Call k's card timestamps read
    ``early[k]`` us early, a pair ``(all, kernel)`` giving the kernel's
    alone apart; the calls of ``without_launches`` lose their runtime
    records."""
    one = [e for e in json.loads(_trace(tmp_path, 0.0).read_text())["traceEvents"] if e["ts"] < 250]
    events = []
    for k, skew in enumerate(early):
        skew, kernel_skew = skew if isinstance(skew, tuple) else (skew, skew)
        for e in one:
            e = json.loads(json.dumps(e))
            e["ts"] += k * APART
            if "correlation" in e["args"]:
                e["args"]["correlation"] += 10 * k
            if e["cat"] in tracing.DEVICE_CATS:
                e["ts"] -= kernel_skew if e["cat"] == "kernel" else skew
            elif e["cat"] == "cuda_runtime" and k in without_launches:
                continue
            events.append(e)
    path = tmp_path / "calls.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


THREE = [("compress", 670_000)] * 3


def _same(a, b) -> bool:
    """Whether two ``spans.CallTimes`` agree to rounding."""
    return dataclasses.astuple(a)[1:] == pytest.approx(dataclasses.astuple(b)[1:], abs=1e-12) and a.direction == b.direction


def test_one_calls_skew_moves_that_calls_readings_only(tmp_path):
    """The middle call's kernel reads 270 us earlier than the rest of the
    card (a shift of 270 us was seen in one stretch on an H100), more than
    ``spans.QUEUE`` above the other calls' lags: that call takes its own
    lag, the line keeps to the others, and they read as without it."""
    even = _record(_calls(tmp_path, [SKEW] * 3), THREE)
    skewed = _record(_calls(tmp_path, [SKEW, (SKEW, SKEW + 270), SKEW]), THREE)
    assert [d / US for d in even.call_shifts] == pytest.approx([SKEW] * 3)
    assert [d / US for d in skewed.call_shifts] == pytest.approx([SKEW, SKEW + 265, SKEW])
    before, after = spans.per_call(even), spans.per_call(skewed)
    assert _same(after[0], before[0]) and _same(after[2], before[2]) and not _same(after[1], before[1])
    # the program span [102, 150] of the call less its kernel, now at 130-170; the memset lies 265 us late
    assert (before[1].program_idle_s / US, after[1].program_idle_s / US) == pytest.approx((31, 28))
    assert sum(s for _, s in spans.idle_by_host(skewed)) == pytest.approx(spans.idle_s(skewed))
    skewed.call_shifts = [max(skewed.call_shifts)] * 3  # one shift a trace: every call's readings move
    assert not any(_same(a, b) for a, b in zip(spans.per_call(skewed), before))


def test_a_skew_within_the_queue_lifts_the_line_for_every_call(tmp_path):
    """The limit of the rule: a call whose kernel reads 60 us early, no
    more than ``spans.QUEUE`` above the others, cannot be told from the
    clock, and every call takes its lag."""
    rec = _record(_calls(tmp_path, [SKEW, (SKEW, SKEW + 60), SKEW]), THREE)
    assert [d / US for d in rec.call_shifts] == pytest.approx([SKEW + 55] * 3)


def test_the_line_follows_a_drift_and_keeps_each_calls_wait(tmp_path):
    """``spans.SLOPE_CALLS`` calls, the card's clock drifting 7 us a ms
    against the host's (on an H100 up to 7.3 us a ms was read). In the odd
    calls the memset waits 8 us on the card and the kernel 5: the line gives
    each call the drift, and the odd calls keep their waits, which their own
    lags, 5 us short, would wipe out; each call reads as with no drift."""
    n = spans.SLOPE_CALLS
    odd = lambda k, skew: (skew - 8, skew) if k % 2 else skew  # noqa: E731
    calls = [("compress", 670_000)] * n
    drifting = _record(_calls(tmp_path, [odd(k, SKEW + 7.0 * k) for k in range(n)]), calls)
    steady = _record(_calls(tmp_path, [odd(k, SKEW) for k in range(n)]), calls)
    assert [d / US for d in drifting.call_shifts] == pytest.approx([SKEW + 7.0 * k for k in range(n)])
    assert [spans.clock_shift(c.ops) / US for c in drifting.calls][1::2] == pytest.approx(
        [SKEW + 7.0 * k - 5 for k in range(1, n, 2)])
    assert all(_same(a, b) for a, b in zip(spans.per_call(drifting), spans.per_call(steady)))
    # the odd calls' memset at 130-132, kernel at 135-175: [102, 150] less 130-132 and 135-150
    assert spans.per_call(drifting)[1].program_idle_s / US == pytest.approx(31)


def test_a_call_without_launches_takes_the_line_and_is_counted(tmp_path):
    """The middle call's runtime records are missing, and its three
    operations are counted, of which the memset's middle on the card's clock
    lies in no call. Its shift is the line's: with two calls' lags, no
    slope, and the larger lag, 50 us."""
    rec = _record(_calls(tmp_path, [30.0, SKEW, 50.0], without_launches=(1,)), THREE)
    assert [d / US for d in rec.call_shifts] == pytest.approx([50.0, 50.0, 50.0])
    assert rec.ops_without_launch == 3 and [len(c.ops) for c in rec.calls] == [3, 2, 3]
    assert harness.traced_device(rec)["ops_without_launch"] == 3 and rec.launches_without_op == 0
    assert harness.traced_device(rec)["clock_shift_us"] == pytest.approx({"median": 50.0, "max": 50.0})


def test_a_launch_whose_operation_the_trace_lost_is_counted(tmp_path):
    """The first call's kernel is missing from the card's records and its
    launch is not (seen on an H100 for a stretch's first call): one launch
    without an operation, which no other count shows."""
    assert tracing.launches_without_op(tracing.load_events(_calls(tmp_path, [SKEW] * 3))) == 0
    path = _calls(tmp_path, [SKEW] * 3)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if not (e["cat"] == "kernel" and e["args"]["correlation"] == 2)]
    path.write_text(json.dumps({"traceEvents": events}))
    rec = _record(path, THREE)
    assert rec.launches_without_op == 1 and rec.ops_without_launch == 0
    assert [len(c.ops) for c in rec.calls] == [2, 3, 3] and harness.traced_device(rec)["launches_without_op"] == 1


#: every per-layer reader of ``BENCHMARK.json`` on the H100 traces under ``data/``, read through
#: ``harness.read_record`` before the program's spans and each call's shift were attached there (the
#: six program-span readers through ``spans`` then); the readers not named here read None
PINNED = {
    "h100_cesm_trace.json": {
        "kernel_roofline_pct.compress": 29.92841301878009, "kernel_roofline_pct.decompress": 49.202741717089985,
        "device_idle_pct.compress": 96.66146621000316, "device_idle_pct.decompress": 90.78427110271696,
        "device_ops_per_call.compress": 3.0, "device_ops_per_call.decompress": 1.0},
    "h100_cesm_trace_spans.json": {
        "kernel_roofline_pct.compress": 29.83559833190245, "kernel_roofline_pct.decompress": 50.18278134263282,
        "device_idle_pct.compress": 74.01705169597885, "device_idle_pct.decompress": 80.91553254939073,
        "device_ops_per_call.compress": 3.0, "device_ops_per_call.decompress": 1.0,
        "glue_us.compress": 60.27170456945896, "glue_us.decompress": 53.227956717213,
        "launch_us.compress": 47.704592968026795, "launch_us.decompress": 47.86268497506777,
        "idle_in_program_pct.compress": 50.07484523044152, "idle_in_program_pct.decompress": 56.756092476666346},
}


@pytest.mark.parametrize("name", list(PINNED))
def test_the_traces_recorded_on_the_card_read_through_the_harness_as_before(bench, name):
    path = DATA / name
    host, _ = _read(path)
    rec = harness.read_record(path, [(s.name.split(".", 1)[1], CESM_CALL) for s in host], 3.35e12)
    for m in bench["per_layer"]:
        value = harness.load_reader("metrics", m["name"])(rec)
        expected = PINNED[name].get(m["name"])
        assert value == (None if expected is None else pytest.approx(expected, rel=1e-12)), m["name"]
        metric, direction = m["name"].split(".", 1)
        if metric in ("glue_us", "launch_us", "idle_in_program_pct"):
            assert value == getattr(spans, metric)(rec, direction)
    assert rec.ops_without_launch == rec.launches_without_op == 0


def _spanned_program():
    """The program's plain versions, each call inside the program's API
    span, with its work less the input's check inside an ``ndzip.launch``
    span, as ``codec_cuda`` opens them on the card."""
    import torch

    def api(direction, fn):
        def call(x, *args):
            with torch.profiler.record_function(spans.API[direction]):
                x = x.contiguous()
                with torch.profiler.record_function(spans.LAUNCH):
                    return fn(x, *args)
        return call

    return types.SimpleNamespace(compress_device=api("compress", ndzip_tpu_torch.compress_device),
                                 decompress_device=api("decompress", ndzip_tpu_torch.decompress_device))


def test_the_traced_run_reads_the_program_spans(bench, tiny_root):
    cell = next(c for c in bench["workloads"] if c["name"] == "cesm.fields")
    r = harness.run_cell(bench, cell, 2**31 + 13, 0.3, True, "cpu", _spanned_program(), root=tiny_root)
    assert r.correct
    times = spans.per_call(r.record)
    for d in ("compress", "decompress"):
        for metric in ("glue_us", "launch_us", "idle_in_program_pct"):
            assert r.metrics[f"{metric}.{d}"]["value"] > 0
        mine = [t for t in times if t.direction == d]
        assert r.metrics[f"glue_us.{d}"]["value"] + r.metrics[f"launch_us.{d}"]["value"] == pytest.approx(
            1e6 * sum(t.api_s for t in mine) / len(mine))
        assert r.metrics[f"idle_in_program_pct.{d}"]["value"] <= tracing.idle_pct(r.record, d)
    # no operation on the CPU's card: no shift, nothing without a launch, and idle wherever the host is
    assert r.device["clock_shift_us"] == {"median": 0.0, "max": 0.0}
    assert r.device["ops_without_launch"] == r.device["launches_without_op"] == 0
    by = dict(r.breakdown["idle_by_host"])
    assert {"portbench.compress", "portbench.decompress", spans.LAUNCH, *spans.API.values()} == set(by)
    assert sum(by.values()) == pytest.approx(spans.idle_s(r.record))
    assert set(r.breakdown) == {"device_ops", "idle_gaps", "idle_by_host"}


def test_the_host_split_cuts_a_call_where_the_spans_cut_it(bench, tiny_root):
    """``trace_spans.host_split_us`` times the API functions and the launches
    of a program laid out as ``codec_cuda`` is, untraced, and gives every
    function back as it found it."""
    import time

    def launch(fn, *args):
        time.sleep(2e-4)
        return fn(*args)

    def api(direction):
        def call(x, *args):
            time.sleep(1e-4)
            return cc._launch(getattr(ndzip_tpu_torch, f"{direction}_device"), x, *args)
        return call

    cc = types.SimpleNamespace(_launch=launch, compress_device=api("compress"), decompress_device=api("decompress"))
    program = types.SimpleNamespace(codec_cuda=cc, compress_device=lambda x: cc.compress_device(x),
                                    decompress_device=lambda *a: cc.decompress_device(*a))
    before = dict(vars(cc))
    mix = tiny_root / "traffic" / "device.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), trace_seconds=0.05)))
    cell = next(c for c in bench["workloads"] if c["name"] == "cesm.fields")
    split = trace_spans.trace_cell(cell, 2**31 + 17, "cpu", program, stretches=1, root=tiny_root)["host_split_us"]
    assert vars(cc) == before
    for d in ("compress", "decompress"):
        t = split[d]
        assert t["calls"] > 0 and t["launch"] >= 200 and t["glue"] >= 100 and t["call"] >= t["api"] > t["launch"]
        assert t["glue"] == pytest.approx(t["api"] - t["launch"])
