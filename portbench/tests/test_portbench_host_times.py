"""The readers of the program's ring of host times (``glue_host_us.*``,
``launch_host_us.*``): the medians of a seeded ring, over its calls made
with no span recorded; nothing on the CPU, where the ring holds no call, and
nothing from a program without the ring."""

import statistics
import sys
import types

import numpy as np
import pytest

import ndzip_tpu_torch
from ndzip_tpu_torch import codec_cuda
from portbench import harness

READERS = [f"{m}.{d}" for m in ("glue_host_us", "launch_host_us") for d in harness.DIRECTIONS]
LAYERS = {"glue_host_us": "codec_cuda glue",
          "launch_host_us": "codec_cuda launch (current device, raw stream handle, ctypes, CUDA runtime)"}


@pytest.fixture(autouse=True)
def empty_ring():
    """The program's ring refilled with ``None`` as at import, and given back after."""
    ring, saved = codec_cuda._RING, list(codec_cuda._RING)
    ring.extend([None] * codec_cuda.HOST_TIMES)
    yield
    ring.extend(saved)


def _read(name):
    return harness.load_reader("metrics", name)(None)


def test_the_four_metrics_are_in_every_cell(bench):
    cells = [w["name"] for w in bench["workloads"]]
    found = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(found) == set(READERS)
    for name, m in found.items():
        metric, direction = name.split(".")
        assert m == {"name": name, "unit": "us/call", "better": "lower", "source": "program_span",
                     "layer": LAYERS[metric], "moves": f"{direction}_gbps", "workloads": cells}


def test_the_readers_give_the_medians_of_a_seeded_ring():
    """3,000 calls of random direction, span flag and times: each reader
    gives the median over its direction's calls with no span."""
    rng = np.random.default_rng(2**31 + 29)
    n, t = 3000, 1_700_000_000_000_000_000
    directions = rng.choice(harness.DIRECTIONS, n)
    spanned = rng.random(n) < 0.3
    launch = rng.integers(5_000, 40_000, n)
    glue = rng.integers(8_000, 60_000, n)
    for i in range(n):
        codec_cuda._RING.append((str(directions[i]), t, t + int(glue[i] + launch[i]), int(launch[i]),
                                 bool(spanned[i])))
        t += 200_000
    for d in harness.DIRECTIONS:
        mine = (directions == d) & ~spanned
        assert mine.sum() > 1000
        assert _read(f"glue_host_us.{d}") == pytest.approx(statistics.median(glue[mine] / 1e3), abs=1e-9)
        assert _read(f"launch_host_us.{d}") == pytest.approx(statistics.median(launch[mine] / 1e3), abs=1e-9)


def test_a_ring_of_spanned_calls_alone_reads_nothing():
    for d in harness.DIRECTIONS * 10:
        codec_cuda._RING.append((d, 0, 30_000, 10_000, True))
    assert [_read(name) for name in READERS] == [None] * 4


@pytest.mark.parametrize("program", ["no module", "no ring"])
def test_a_program_without_the_ring_reads_nothing(monkeypatch, program):
    if program == "no module":
        monkeypatch.delitem(sys.modules, "ndzip_tpu_torch.codec_cuda")
    else:
        monkeypatch.setitem(sys.modules, "ndzip_tpu_torch.codec_cuda", types.SimpleNamespace(LAUNCHES={}))
    assert [_read(name) for name in READERS] == [None] * 4


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_run_on_the_cpu_reads_nothing_from_the_ring(bench, tiny_root, trace):
    """The cell's calls go to the plain versions, never to ``codec_cuda``:
    the ring stays empty and the traced line leaves the four metrics out."""
    cell = next(c for c in bench["workloads"] if c["name"] == "cesm.fields")
    r = harness.run_cell(bench, cell, 2**31 + 31, 0.3, trace, "cpu", ndzip_tpu_torch, root=tiny_root)
    assert r.correct and codec_cuda.host_times() == []
    assert not set(READERS) & set(r.metrics)
    if trace:  # the traced line's other readers read
        assert "device_idle_pct.compress" in r.metrics
