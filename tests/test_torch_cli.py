"""The port's command-line tools: ``cli`` (the cases of tests/test_cli_io.py
that apply, and byte equality with the JAX package's CLI), ``ubench`` on the
CPU and ``warm`` without a GPU. The tools run in-process through their
``run``/``main`` functions, and as ``python -m`` where a test needs stdin
and stdout. On a card (marker ``cuda``): ``-e cuda`` round trips through
files, ``warm`` finding the library already built, and ``ubench``
launching every stage kernel."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu import cli as jax_cli  # noqa: E402
from ndzip_tpu import golden, native  # noqa: E402
from ndzip_tpu_torch import _build, api, bench, cli, stages, ubench, warm  # noqa: E402
from torch_cases import fp64_kernel_cases  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(78)


def run_module(module, args, stdin: bytes = b""):
    res = subprocess.run([sys.executable, "-m", module, *args], input=stdin, capture_output=True, cwd=REPO,
                         timeout=300)
    return res.returncode, res.stdout, res.stderr.decode()


def shape_flags(data):
    return ["-n", *map(str, data.shape), "-t", "float" if data.dtype == np.float32 else "double"]


@pytest.mark.parametrize("backend", ["golden", "cpu", "torch"])
def test_cli_roundtrip_files(tmp_path, capsys, backend):
    if backend == "cpu" and not native.available():
        pytest.skip("the native CPU codec is not built on this machine")
    data = RNG.standard_normal((70, 65)).astype(np.float32)
    raw, comp, back = tmp_path / "in.f32", tmp_path / "out.ndz", tmp_path / "back.f32"
    raw.write_bytes(data.tobytes())
    assert cli.run(shape_flags(data) + ["-e", backend, "-i", str(raw), "-o", str(comp)]) == 0
    assert "ratio" in capsys.readouterr().err
    assert comp.read_bytes() == golden.compress(data)[0].tobytes()
    assert cli.run(["-d"] + shape_flags(data) + ["-e", backend, "-i", str(comp), "-o", str(back)]) == 0
    assert back.read_bytes() == data.tobytes()


def test_cli_stdin_stdout_multichunk():
    # 3 arrays of 4097 floats in one stream (compress.cc:17-86)
    datas = [RNG.standard_normal(4097).astype(np.float32) for _ in range(3)]
    raw = b"".join(d.tobytes() for d in datas)
    rc, compressed, err = run_module("ndzip_tpu_torch.cli", ["-n", "4097", "-t", "float", "-e", "torch"], raw)
    assert rc == 0, err
    assert compressed == b"".join(golden.compress(d)[0].tobytes() for d in datas)
    rc, decompressed, err = run_module("ndzip_tpu_torch.cli", ["-d", "-n", "4097", "-t", "float", "-e", "torch"],
                                       compressed)
    assert rc == 0, err
    assert decompressed == raw


def test_cli_double_no_mmap(tmp_path):
    data = RNG.standard_normal((65, 64)).astype(np.float64)
    raw, comp, back = tmp_path / "in.f64", tmp_path / "c.ndz", tmp_path / "back.f64"
    raw.write_bytes(data.tobytes())
    assert cli.run(shape_flags(data) + ["-e", "torch", "--no-mmap", "-i", str(raw), "-o", str(comp)]) == 0
    assert comp.read_bytes() == golden.compress(data)[0].tobytes()
    assert cli.run(["-d", "--no-mmap"] + shape_flags(data) + ["-e", "torch", "-i", str(comp), "-o", str(back)]) == 0
    assert back.read_bytes() == data.tobytes()


def test_cli_rejects_bad_dims(capsys):
    assert cli.run(["-n", "2", "2", "2", "2", "-t", "float"]) != 0
    assert "dimension" in capsys.readouterr().err


def test_cli_truncated_input(tmp_path, capsys):
    raw = tmp_path / "in.f32"
    raw.write_bytes(b"\0" * 10)  # not a whole 4096-element chunk
    assert cli.run(["-n", "4096", "-t", "float", "-e", "torch", "-i", str(raw), "-o", str(tmp_path / "o")]) != 0
    assert "end of input" in capsys.readouterr().err


def test_cli_cuda_without_a_gpu_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = tmp_path / "in.f32"
    raw.write_bytes(np.zeros(4096, np.float32).tobytes())
    assert cli.run(["-n", "4096", "-e", "cuda", "-i", str(raw), "-o", str(tmp_path / "o")]) != 0
    assert "GPU" in capsys.readouterr().err


def test_cli_without_an_encoder_or_a_gpu_fails(tmp_path, capsys, monkeypatch):
    """No -e is the card, as the API's default: without a GPU the CLI exits
    nonzero naming it and writes nothing, where it once fell back to a CPU
    codec."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(api.BACKEND_ENV, raising=False)
    raw, out = tmp_path / "in.f32", tmp_path / "o"
    raw.write_bytes(np.zeros(4096, np.float32).tobytes())
    for flags in ([], ["-d"]):
        assert cli.run(["-n", "4096", *flags, "-i", str(raw), "-o", str(out)]) == 1
        assert "needs an NVIDIA GPU" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("backend", ["golden", "torch"])
def test_cli_without_an_encoder_takes_the_variable(tmp_path, capsys, monkeypatch, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv(api.BACKEND_ENV, backend)
    data = np.sin(np.arange(4096 + 9, dtype=np.float32))
    raw, ndz = tmp_path / "in.f32", tmp_path / "o.ndz"
    raw.write_bytes(data.tobytes())
    assert cli.run(["-n", str(data.size), "-i", str(raw), "-o", str(ndz)]) == 0
    assert ndz.read_bytes() == golden.compress(data)[0].tobytes()
    assert f"default->{backend}" in capsys.readouterr().err


@pytest.mark.parametrize("shape", [(4096 * 2 + 5,), (130, 70), (17, 32, 33)], ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_cli_output_equals_the_jax_package_cli(tmp_path, dtype, shape):
    """``python -m ndzip_tpu.cli -e golden`` and ``python -m
    ndzip_tpu_torch.cli -e torch`` write the same bytes, and the port decodes
    the JAX package's file."""
    data = np.random.default_rng(len(shape)).standard_normal(shape).astype(dtype)
    data.reshape(-1)[:300] = 0
    raw, theirs, ours, back = (tmp_path / n for n in ("in.raw", "jax.ndz", "port.ndz", "back.raw"))
    raw.write_bytes(data.tobytes())
    flags = shape_flags(data)
    assert jax_cli.run(flags + ["-e", "golden", "-i", str(raw), "-o", str(theirs)]) == 0
    assert cli.run(flags + ["-e", "torch", "-i", str(raw), "-o", str(ours)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert cli.run(["-d"] + flags + ["-e", "torch", "-i", str(theirs), "-o", str(back)]) == 0
    assert back.read_bytes() == raw.read_bytes()


# ------------------------------------------------------------ ubench and warm


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_ubench_on_the_cpu_runs_every_plain_stage(capsys, dims):
    assert ubench.main(["--device", "cpu", "--mb", "0.25", "--dims", str(dims)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# shape=") and "cpu" in lines[0]
    assert [line.split()[0] for line in lines[1:]] == list(ubench.PLAIN_STAGES)
    assert all("ms/rep" in line and "GB/s" in line for line in lines[1:])


def test_ubench_refuses_kernel_stages_on_the_cpu(capsys):
    assert ubench.main(["--device", "cpu", "--mb", "0.25", "--stages", "placement"]) != 0
    assert "--device cuda" in capsys.readouterr().err
    assert ubench.main(["--device", "cpu", "--mb", "0.25", "--stages", "nothing"]) != 0


def test_ubench_cuda_without_a_gpu_exits_nonzero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ubench.main(["--mb", "0.25"]) != 0
    assert "GPU" in capsys.readouterr().err


def test_ubench_shape_rule():
    assert ubench.working_shape(64, 1) == (2**24,)
    assert ubench.working_shape(64, 2) == (4096, 4096)
    assert ubench.working_shape(64, 3) == (256, 256, 256)
    assert ubench.working_shape(64, 3, "double") == (192, 192, 192)
    with pytest.raises(ValueError, match="no whole block"):
        ubench.working_shape(0.001, 3)


def test_warm_without_a_gpu_exits_nonzero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert warm.run(["--shapes", "4096"]) != 0
    assert "GPU" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        warm.build_parser().parse_args(["--shapes", "bad"])


def test_warm_without_nvcc_exits_nonzero(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "library_path", lambda *csrc: tmp_path / "libndzip_cuda_test.so")
    _build.load.cache_clear()
    assert warm.run(["--shapes", "4096"]) != 0
    assert "nvcc not found" in capsys.readouterr().err


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CLI_CASES = {
    "CESM 1800x3600 fp32": lambda: bench.cesm(np.random.default_rng(0)),
    "fp64 3d border (17,32,129)": lambda: fp64_kernel_cases()["3d odd minor extent (17,32,129)"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CUDA_CLI_CASES))
def test_cuda_cli_round_trip_files(cuda, tmp_path, label):
    """``-e cuda`` through files: the .ndz file is golden's stream, the
    decompressed file the input."""
    data = CUDA_CLI_CASES[label]()
    raw, comp, back = tmp_path / "in.raw", tmp_path / "out.ndz", tmp_path / "back.raw"
    raw.write_bytes(data.tobytes())
    assert cli.run(shape_flags(data) + ["-e", "cuda", "-i", str(raw), "-o", str(comp)]) == 0
    assert comp.read_bytes() == golden.compress(data)[0].tobytes()
    assert cli.run(["-d"] + shape_flags(data) + ["-e", "cuda", "-i", str(comp), "-o", str(back)]) == 0
    assert back.read_bytes() == raw.read_bytes()


@pytest.mark.cuda
def test_cuda_warm_finds_the_built_library(cuda, capsys):
    lib = _build.build()
    built = lib.stat().st_mtime_ns
    assert warm.run(["--shapes", "16777216", "1800x3600", "--dtype", "float", "double"]) == 0
    err = capsys.readouterr().err
    assert f"kernel library {lib.name}: found" in err and "MISMATCH" not in err
    assert err.count("warmed ") == 4
    assert lib.stat().st_mtime_ns == built


@pytest.mark.cuda
def test_cuda_ubench_launches_every_stage_kernel(cuda, capsys):
    for k in stages.LAUNCHES:
        stages.LAUNCHES[k] = 0
    for dims, dtype in ((1, "float"), (2, "float"), (3, "float"), (3, "double")):
        assert ubench.main(["--mb", "4", "--dims", str(dims), "--dtype", dtype]) == 0
    torch.cuda.synchronize()
    assert all(stages.LAUNCHES.values()), stages.LAUNCHES
    assert "GB/s" in capsys.readouterr().out
