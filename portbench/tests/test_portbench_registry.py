"""BENCHMARK.json against the harness's files, and a cell added by new files alone."""

import json
import re

import pytest
import torch

import ndzip_tpu_torch
from portbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_every_name_has_its_file(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
        loaded = harness.load_config(cfg["name"])
        assert loaded["name"] == cfg["name"] and loaded["source"] == cfg["source"] and cfg["reduced"] == []
    configs = {c["name"] for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert cell["config"] in configs and cell["chips"] == 1
        assert callable(harness.load_entry(harness.load_mix(cell["traffic"])["entry"]))
    for m in bench["end_to_end"]:
        assert callable(harness.load_reader("endtoend", m["name"]))
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(harness.load_reader("metrics", m["name"]))
        assert set(m["workloads"]) <= cells and m["moves"] in {e["name"] for e in bench["end_to_end"]}
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[sec]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, "end_to_end", cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, "per_layer", cell["name"])


@pytest.mark.parametrize("name", ["../configs/x", "a/b", "", ".hidden", "x" * 65])
def test_a_name_that_is_not_one_is_refused(name):
    with pytest.raises(ValueError):
        harness.load_config(name)


def test_a_missing_file_is_named(tiny_root):
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        harness.load_mix("no_such_mix", tiny_root)


def test_a_cell_added_by_new_files_alone(bench, tiny_root):
    """A later change adds a configuration, a traffic mix with an entry of
    its own, an end-to-end and a per-layer metric as new files and
    BENCHMARK.json entries; the harness runs the new cell unchanged."""
    (tiny_root / "configs" / "line_f64_1d.json").write_text(json.dumps({
        "name": "line_f64_1d", "source": "a test", "reduced": [], "shape": [3 * 4096 + 77],
        "dtype": "float64", "fields": 2, "formula": {"axes": [{"fn": "sin", "span": 30.0}], "noise": 1e-3}}))
    (tiny_root / "traffic" / "device_lone.json").write_text(json.dumps({
        "entry": "device_copy", "why": "one sample a field", "sample_per_field": 1, "warm_sweeps": 2, "warm_seconds": 0.0,
        "trace_seconds": 0.05}))
    (tiny_root / "entries" / "device_copy.py").write_text(
        "from portbench.entries.device import Entry as Device\n\n\n"
        "class Entry(Device):\n"
        "    def decompress(self, stream, like):\n"
        "        return super().decompress(stream.clone(), like)\n")
    (tiny_root / "endtoend" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / sum(c.seconds for c in run.calls)\n")
    (tiny_root / "metrics" / "traced_calls.py").write_text("def read(rec):\n    return len(rec.calls)\n")
    bench = dict(bench)
    bench["configs"] = bench["configs"] + [{"name": "line_f64_1d", "source": "a test",
                                            "file": "portbench/configs/line_f64_1d.json", "reduced": [],
                                            "why": "test"}]
    cell = {"name": "line.device", "config": "line_f64_1d", "traffic": "device_lone", "chips": 1, "why": "test"}
    bench["workloads"] = bench["workloads"] + [cell]
    bench["end_to_end"] = bench["end_to_end"] + [{"name": "calls_per_s", "unit": "1/s", "better": "higher",
                                                  "bound": 0.05, "source": "host_clock",
                                                  "workloads": ["line.device"]}]
    bench["per_layer"] = bench["per_layer"] + [{"name": "traced_calls", "unit": "calls", "better": "higher",
                                                "source": "program_span", "layer": "test",
                                                "moves": "calls_per_s", "workloads": ["line.device"]}]
    r = harness.run_cell(bench, cell, 7, 0.2, False, "cpu", ndzip_tpu_torch, root=tiny_root)
    assert r.correct and r.metrics["calls_per_s"]["value"] > 0
    assert {"compress_gbps", "setup_s", "calls_per_s"} <= set(r.metrics)
    assert r.device["platform"] == "cpu"
    r = harness.run_cell(bench, cell, 7, 0.2, True, "cpu", ndzip_tpu_torch, root=tiny_root)
    assert r.correct and r.metrics["traced_calls"]["value"] >= 4
    assert "kernel_roofline_pct.compress" not in r.metrics  # nothing to read on the CPU: left out, not 0


def test_fields_follow_the_seed(tiny_root):
    cfg = harness.load_config("cesm_atm_f32_2d", tiny_root)
    a, b = harness.make_fields(cfg, 2**31 + 5, "cpu"), harness.make_fields(cfg, 2**31 + 5, "cpu")
    c = harness.make_fields(cfg, 2**31 + 6, "cpu")
    assert len(a) == cfg["fields"] and all(x.shape == (130, 200) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
