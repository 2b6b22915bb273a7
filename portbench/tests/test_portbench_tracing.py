"""The per-layer readers and the traced run's breakdown, on a chrome trace
written as ``torch.profiler`` writes one: the benchmark's spans on the host,
kernels, memsets and copies on the card, in microseconds."""

import json
from pathlib import Path

import pytest

from portbench import harness, roofline, tracing

PEAK = 3.35e12
US = 1e-6


def _read(path):
    """``(spans, ops)`` of the chrome trace at ``path``."""
    return tracing.read_events(tracing.load_events(path))


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 1, "ts": ts, "dur": dur, "args": args}


def _trace(tmp_path, skew=0.0):
    """Two calls. compress [100, 200] us: memset 110-112, encode 115-175,
    copy 180-181, launched at 105, 113 and 178. decompress [250, 330] us:
    decode 260-300, launched at 255. Also a copy after the calls
    (400-405) with no launch in the trace, a cuda_runtime call that
    launched nothing, a gpu_user_annotation record, which is not a device
    operation, and a span of another name. ``skew`` shifts the card's clock
    against the host's."""
    events = [
        _x("user_annotation", "portbench.compress", 100, 100),
        _x("cuda_runtime", "cudaMemsetAsync", 105, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 113, 2, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 178, 3, correlation=3),
        _x("cuda_runtime", "cudaStreamSynchronize", 182, 10, correlation=4),
        _x("gpu_memset", "Memset (Device)", 110 + skew, 2, correlation=1),
        _x("kernel", "void encode_blocks_nd<3>(...)", 115 + skew, 60, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 180 + skew, 1, correlation=3),
        _x("gpu_user_annotation", "portbench.compress", 110, 71),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 400 + skew, 5),
        _x("user_annotation", "portbench.decompress", 250, 80),
        _x("user_annotation", "other span", 250, 80),
        _x("cuda_runtime", "cudaLaunchKernel", 255, 2, correlation=9),
        _x("kernel", "void decode_blocks_nd<3>(...)", 260 + skew, 40, correlation=9),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 270},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.fixture(params=[0.0, -40.0, 30.0], ids=["aligned", "card-early", "card-late"])
def rec(tmp_path, request):
    spans, ops = _read(_trace(tmp_path, request.param))
    assert [s.name for s in spans] == ["portbench.compress", "portbench.decompress"]
    assert len(ops) == 5
    return tracing.build_record(spans, ops, [("compress", 670_000), ("decompress", 670_000)], PEAK)


def test_each_operation_goes_to_the_call_that_launched_it(rec):
    assert [len(c.ops) for c in rec.calls] == [3, 1]
    assert len(rec.ops) == 4  # the copy launched by no call is in none
    assert tracing.ops_per_call(rec, "compress") == 3
    assert tracing.ops_per_call(rec, "decompress") == 1


def test_roofline_counts_kernels_and_memsets_not_copies(rec):
    bound = 670_000 / PEAK
    assert tracing.roofline_pct(rec, "compress") == pytest.approx(100 * bound / (62 * US))
    assert tracing.roofline_pct(rec, "decompress") == pytest.approx(100 * bound / (40 * US))
    rec.kernel_seconds["decompress"] = 80 * US  # the CUDA events' stand-in
    assert tracing.roofline_pct(rec, "decompress") == pytest.approx(100 * bound / (80 * US))
    rec.peak_bytes_per_s = None
    assert tracing.roofline_pct(rec, "compress") is None


def test_idle_and_copy_shares(rec):
    assert tracing.idle_pct(rec, "compress") == pytest.approx(100 * (1 - 63 / 100))
    assert tracing.idle_pct(rec, "decompress") == pytest.approx(100 * (1 - 40 / 80))
    assert tracing.copy_pct(rec, "compress") == pytest.approx(1.0)
    assert tracing.copy_pct(rec, "decompress") is None  # no copy to read


def test_busy_window_and_breakdown(rec):
    busy, window = tracing.busy_and_window(rec)
    assert window == pytest.approx(230 * US) and busy == pytest.approx(103 * US)
    b = tracing.breakdown(rec)
    assert b["device_ops"][0] == ["void encode_blocks_nd<3>(...)", pytest.approx(60 * US)]
    assert b["device_ops"][1][0] == "void decode_blocks_nd<3>(...)" and len(b["device_ops"]) == 4
    assert [[n, round(s / US, 6)] for n, s in b["idle_gaps"]] == [
        ["between portbench.compress and portbench.decompress", 79], ["portbench.compress", 5],
        ["portbench.compress", 3]]
    assert json.loads(json.dumps(b)) == b


def test_spans_that_do_not_match_the_calls_are_refused(tmp_path):
    spans, ops = _read(_trace(tmp_path))
    with pytest.raises(ValueError):
        tracing.build_record(spans, ops, [("compress", 1)], PEAK)
    with pytest.raises(ValueError):
        tracing.build_record(spans, ops, [("decompress", 1), ("compress", 1)], PEAK)


def test_the_readers_read_the_record(bench, rec):
    for m in bench["per_layer"]:
        value = harness.load_reader("metrics", m["name"])(rec)
        assert value is None or value >= 0


def test_the_peak_table():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("a card of no table") is None


def test_a_trace_recorded_on_the_card():
    """Two compress and two decompress calls of a 1800x3600 fp32 field,
    traced on an NVIDIA H100 80GB HBM3 as the harness traces them."""
    spans, ops = _read(Path(__file__).parent / "data" / "h100_cesm_trace.json")
    calls = [("compress", 6_480_000 * 4 + 4 * 4_360_000), ("decompress", 6_480_000 * 4 + 4 * 4_360_000)] * 2
    rec = tracing.build_record(spans, ops, calls, PEAK)
    assert [len(c.ops) for c in rec.calls] == [3, 1, 3, 1]
    assert [o.cat for o in rec.calls[0].ops] == ["gpu_memset", "kernel", "gpu_memcpy"]
    assert "encode_blocks_nd<2>" in rec.calls[0].ops[1].name and "decode_blocks_nd<2>" in rec.calls[1].ops[0].name
    for d in ("compress", "decompress"):
        assert 0 < tracing.roofline_pct(rec, d) < 100 and 0 < tracing.idle_pct(rec, d) < 100
    busy, window = tracing.busy_and_window(rec)
    assert 0 < busy < window
    b = tracing.breakdown(rec)
    assert "encode_blocks_nd<2>" in b["device_ops"][0][0] and len(b["device_ops"]) == 4
    # the longest: from the first length copy to the first decode, the host between the calls
    assert b["idle_gaps"][0][0] == "between portbench.compress and portbench.decompress"
