"""The port's headline bench (``ndzip_tpu_torch.bench``): its cells' data is
bench.py's (the ratios and the streams, against the JAX package's golden),
without a card it times nothing and says so in a line that parses, each cell
is fenced, and the gates run before any timing. On a card (marker ``cuda``)
the runner measures one small cell, and ``python -m ndzip_tpu_torch.bench``
runs as a user runs it: its line names the card, has no error and bench.py's
ratios, and its headline lies within ``HEADLINE_BAND`` of the decoder's own
device time and of the CUDA-event median with the host's gaps in."""

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import bench, golden, utils, variants  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# bench.py's ratios of its four default cells, as BENCH_LAST.json's "extra" records them
BENCH_PY_RATIOS = {"fp32_1d": 0.6214, "fp64": 0.768, "cesm": 0.6715, "cube3d": 0.7475}


@pytest.fixture(scope="module")
def default_cells():
    """The four default cells' data, drawn as the bench draws it, with the port's golden streams."""
    rng = np.random.default_rng(0)
    cells = {}
    for key, make, _ in bench.CELLS:
        data = make(rng)
        cells[key] = (data, *golden.compress(data))
    return cells


@pytest.mark.parametrize("key", list(BENCH_PY_RATIOS))
def test_default_cells_are_bench_py_data(default_cells, key):
    from ndzip_tpu import golden as ref_golden

    data, stream, words = default_cells[key]
    assert round(words * data.itemsize / data.nbytes, 4) == BENCH_PY_RATIOS[key]
    ref_stream, ref_words = ref_golden.compress(data)
    assert words == ref_words and stream.tobytes() == ref_stream.tobytes()


def test_cells_are_bench_py_cells_in_its_order():
    assert [k for k, _, _ in bench.CELLS] == list(BENCH_PY_RATIOS)
    assert [k for k, _, _ in bench.FULL_CELLS] == ["fp64_512cube", "fp32_2gib_3d"]
    assert {g for _, _, g in bench.CELLS} == {"golden"} and {g for _, _, g in bench.FULL_CELLS} == {"plain"}
    assert bench.HEADLINE == "fp32_1d"


def test_bench_without_a_card_times_nothing():
    proc = subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.bench"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["unit"] == "GB/s"
    assert line["value"] is None and line["vs_baseline"] is None and line["error"] == "no_cuda_device"
    assert set(line["extra"]) <= {"last_measured", "mt_scaling"} and "mt_scaling" in line["extra"]
    assert not [k for k in line["extra"] if k.endswith("_gbps")]


def fake_measure(data, gate):
    """Device times in ms from the data's size alone, as if a card had run."""
    mb = data.nbytes / 1e6
    ms = {"compress": mb / 1000, "decompress": mb / 1250, "copy": mb / 2000}
    return {"ms": ms, "gbps": {k: data.nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()}, "ratio": 0.5}


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    """main() as on a card: the cells' measurement, the card's name and the
    host probe stubbed, the cache in a temporary directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(utils, "card", lambda: "Stub GPU, 700.00 W")
    monkeypatch.setattr(bench, "mt_scaling_probe", lambda: "stub")
    monkeypatch.setattr(bench, "LAST_PATH", tmp_path / "bench_last.json")
    monkeypatch.delenv(bench.FULL_ENV, raising=False)
    return tmp_path / "bench_last.json"


def main_line(capsys) -> dict:
    assert bench.main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("failing", list(BENCH_PY_RATIOS))
def test_a_failing_cell_is_fenced(monkeypatch, capsys, fake_card, failing):
    seen = []

    def measure(data, gate, dev):
        seen.append(data.shape)
        if len(seen) == list(BENCH_PY_RATIOS).index(failing) + 1:
            raise RuntimeError("stub failure")
        return fake_measure(data, gate)

    monkeypatch.setattr(bench, "measure_cell", measure)
    line = main_line(capsys)
    extra = line["extra"]
    assert seen == [(2**24,), (2**23,), (1800, 3600), (256, 256, 256)]
    assert extra[f"{failing}_error"] == "RuntimeError: stub failure"
    assert extra["backend"] == "cuda" and extra["device"] == "Stub GPU, 700.00 W"
    for key in BENCH_PY_RATIOS:
        have = {f"{key}_{what}" for what in ("compress_gbps", "decompress_gbps", "copy_gbps", "ratio")} & set(extra)
        assert len(have) == (0 if key == failing else 4)
    if failing == "fp32_1d":
        assert line["value"] is None and line["error"] == "RuntimeError: stub failure"
        assert not fake_card.exists()  # a failed headline is not cached
    else:
        assert "error" not in line and line["value"] == extra["fp32_1d_decompress_gbps"] == 1250.0
        assert line["vs_baseline"] == 0.625 and extra["compress_gbps"] == 1000.0 and extra["ratio"] == 0.5
        assert json.loads(fake_card.read_text()) == line


def test_full_adds_the_full_cells_and_no_card_reads_the_cache(monkeypatch, capsys, fake_card):
    gates = []

    def measure(data, gate, dev):
        gates.append(gate)
        return fake_measure(data, gate)

    monkeypatch.setattr(bench, "measure_cell", measure)
    monkeypatch.setattr(bench, "FULL_CELLS", tuple((k, lambda rng: np.zeros(4096 * 2, np.float32), g)
                                                   for k, _, g in bench.FULL_CELLS))
    monkeypatch.setenv(bench.FULL_ENV, "1")
    line = main_line(capsys)
    assert gates == ["golden"] * 4 + ["plain"] * 2
    assert line["extra"]["fp64_512cube_ratio"] == line["extra"]["fp32_2gib_3d_ratio"] == 0.5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cached = main_line(capsys)
    assert cached["error"] == "no_cuda_device" and cached["extra"]["last_measured"] == line


def small_data():
    return np.sin(np.arange(4096 * 3 + 17, dtype=np.float32) * 1e-3)


@pytest.mark.parametrize("gate", ["golden", "plain"])
def test_measure_cell_gates_before_it_times(gate):
    """On the CPU the gates pass and the first timing raises: nothing is timed without a card."""
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench.measure_cell(small_data(), gate, "cpu")


def test_measure_cell_refuses_a_stream_that_is_not_golden(monkeypatch):
    monkeypatch.setattr(bench.golden, "compress", lambda data: (np.zeros(3, np.uint32), 3))
    with pytest.raises(RuntimeError, match="differs from the golden stream"):
        bench.measure_cell(small_data(), "golden", "cpu")


def test_measure_cell_refuses_a_round_trip_that_is_not_exact(monkeypatch):
    real = bench.decompress_device
    monkeypatch.setattr(bench, "decompress_device", lambda s, shape, dtype: real(s, shape, dtype) + 1)
    with pytest.raises(RuntimeError, match="not bit-exact"):
        bench.measure_cell(small_data(), "plain", "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["golden", "plain"])
def test_cuda_runner_on_one_small_cell(cuda, gate):
    data = small_data()
    rows, extra = bench.run_cells([("small", lambda rng: data, gate)],
                                  lambda d, g: bench.measure_cell(d, g, cuda))
    words = golden.compress(data)[1]
    assert extra["small_ratio"] == round(words * 4 / data.nbytes, 4)
    assert all(extra[f"small_{w}_gbps"] > 0 for w in ("compress", "decompress", "copy"))
    assert "small_error" not in extra and rows["small"]["ms"]["decompress"] > 0


#: where the headline's decompress median may lie: from 0.9 times the decode kernel's device time a
#: launch (launches back to back, an event between every two) to 1.25 times the CUDA-event median of
#: the same call with the host's gaps in
HEADLINE_BAND = (0.9, 1.25)


@pytest.mark.cuda
def test_cuda_bench_as_a_user_runs_it(cuda):
    proc = subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.bench"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    extra = line["extra"]
    assert not [k for k in line | extra if k.endswith("error")], proc.stderr
    assert extra["backend"] == "cuda" and extra["device"] == utils.card() and line["value"] > 0
    assert {k: extra[f"{k}_ratio"] for k in BENCH_PY_RATIOS} == BENCH_PY_RATIOS

    data = bench.fp32_1d(np.random.default_rng(0))
    x = torch.from_numpy(data).to(cuda)
    stream, length = bench.compress_device(x)
    s = stream[: int(length)]

    def decode():
        return bench.decompress_device(s, x.shape, x.dtype)

    head_ms = data.nbytes / (line["value"] * 1e9) * 1e3
    kernel_ms = statistics.median(variants._us_of_launches(decode, bench.REPS)) * 1e-3
    host_ms = utils.device_time_ms(decode, bench.REPS)
    assert HEADLINE_BAND[0] * kernel_ms <= head_ms <= HEADLINE_BAND[1] * host_ms, (kernel_ms, head_ms, host_ms)
