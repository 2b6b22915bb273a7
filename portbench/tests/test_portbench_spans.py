"""The readers of the program's spans (``spans``) and the tool that traces a
cell with them (``trace_spans``): on a chrome trace written as
``torch.profiler`` writes one, with a known skew of the card's clock, on
the H100 traces under ``data/``, and on the CPU through the harness."""

import json
from pathlib import Path

import pytest

import ndzip_tpu_torch
from portbench import harness, spans, trace_spans, tracing

US = 1e-6
DATA = Path(__file__).parent / "data"
#: the card's clock against the host's in ``_trace``: a start reads 40 us early
SKEW = 40.0


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
    timestamps read ``skew`` us early."""
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
    host, ops = tracing.read_chrome_trace(path)
    return spans.attach(tracing.build_record(host, ops, calls, 3.35e12), spans.read_program_spans(path), ops)


@pytest.fixture
def rec(tmp_path):
    return _record(_trace(tmp_path), [("compress", 670_000), ("decompress", 670_000)])


def test_the_program_spans_are_read_and_the_benchmark_reads_them_as_nothing(tmp_path):
    path = _trace(tmp_path)
    assert [s.name for s in spans.read_program_spans(path)] == [
        "ndzip.compress_device", "ndzip.launch", "ndzip.decompress_device", "ndzip.launch"]
    assert [s.name for s in tracing.read_chrome_trace(path)[0]] == ["portbench.compress", "portbench.decompress"]


@pytest.mark.parametrize("skew, shift", [(SKEW, SKEW), (0.0, 0.0), (-30.0, 0.0)],
                         ids=["card-early", "aligned", "card-late"])
def test_the_clock_shift_is_the_skew_that_puts_each_operation_after_its_launch(tmp_path, skew, shift):
    _, ops = tracing.read_chrome_trace(_trace(tmp_path, skew))
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
    bare = tracing.build_record(*tracing.read_chrome_trace(path), [("compress", 1), ("decompress", 1)], None)
    for r in (rec, bare):  # spans attached but none there; nothing attached at all
        for d in ("compress", "decompress"):
            assert spans.glue_us(r, d) is spans.launch_us(r, d) is spans.idle_in_program_pct(r, d) is None
        assert spans.idle_by_host(r) is None and spans.per_call(r) is None


def test_the_existing_readers_read_the_same_with_program_spans(tmp_path, rec):
    """``tracing`` reads a trace with the program's spans as one without."""
    bare = tracing.build_record(*tracing.read_chrome_trace(_bare(tmp_path)), [("compress", 670_000), ("decompress", 670_000)],
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
    host, ops = tracing.read_chrome_trace(path)
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
    spans.attach(rec, spans.read_program_spans(path), ops)
    assert rec.program_spans == [] and spans.idle_by_host(rec) is None


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
        assert s["program_spans"] == 0 and s["clock_shift_us"] == 0.0 and s["breakdown"]["idle_by_host"] is None
        assert not {"glue_us.compress", "launch_us.decompress"} & set(s["metrics"])
        assert s["calls_per_s"]["untraced"] > 0 and s["calls_per_s"]["traced"] > 0
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
    host, ops = tracing.read_chrome_trace(path)
    assert [s.name for s in host] == ["portbench.compress", "portbench.decompress"] * 3
    rec = _record(path, [(s.name.split(".", 1)[1], CESM_CALL) for s in host])
    assert all(o.start + rec.clock_shift >= o.launch for o in ops if o.launch is not None)
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
