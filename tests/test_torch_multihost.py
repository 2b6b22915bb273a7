"""The port's multi-process layer (``ndzip_tpu_torch.parallel.multihost``):
the cases of tests/test_multihost.py, in real processes over a gloo group on
the CPU. Each worker takes its row slab of a grid made here with
``numpy.random.default_rng``, compresses it over its CPU devices and writes
what it got; the stream that ``gather_stream`` assembles and the file that
``compress_to_file`` writes must equal ``ndzip_tpu.golden.compress`` of the
whole grid byte for byte, and the slabs of ``decompress_multihost`` and
``decompress_from_file`` must be the input's, bit for bit. Every worker
imports only ``ndzip_tpu_torch``. Each process has 120 s; on expiry the
workers are killed and the test fails. On a card (marker ``cuda``) two
workers share ``cuda:0`` and compress their slabs there, over gloo as on the
CPU (NCCL refuses two ranks on one card)."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch.parallel import multihost  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120

WORKER = textwrap.dedent("""
    import os, sys
    pid, nproc, port, tmp, ndev, device = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                           int(sys.argv[5]), sys.argv[6])
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch.distributed as dist
    from ndzip_tpu_torch.parallel import multihost

    multihost.init(f"localhost:{{port}}", nproc, pid)
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    devices = [device] * ndev
    full = np.load(os.path.join(tmp, "full.npy"))
    rows = full.shape[0] // nproc
    slab = full[pid * rows: (pid + 1) * rows]

    stream = multihost.gather_stream(multihost.compress_multihost(slab, devices))
    path = os.path.join(tmp, "stream.ndz")
    total = multihost.compress_to_file(slab, path, devices)
    out = multihost.decompress_multihost(np.fromfile(path, np.uint32), full.shape, full.dtype, devices)
    from_file = multihost.decompress_from_file(path, full.shape, full.dtype, devices)
    np.save(os.path.join(tmp, f"slab{{pid}}.npy"), out)
    np.save(os.path.join(tmp, f"file_slab{{pid}}.npy"), from_file)
    if pid == 0:
        np.save(os.path.join(tmp, "gathered.npy"), stream)
        assert total == stream.size, (total, stream.size)
    else:
        assert stream is None
    dist.destroy_process_group()
    foreign = sorted({{m.split(".")[0] for m in sys.modules}} & {{"ndzip_tpu", "jax", "jaxlib"}})
    print(f"proc {{pid}} OK; foreign modules: {{foreign}}", flush=True)
""").format(repo=str(REPO))

CASES = {
    "f32_2d": ((128, 200), np.float32, 1),
    "f64_3d": ((32, 33, 35), np.float64, 1),
    # the slab decoded (and encoded) over two local devices, as
    # ndzip_tpu/parallel/multihost.py:381-391 decodes over a process's chips
    "f32_2d_localmesh": ((128, 200), np.float32, 2),
    # 3 blocks a process over 2 local shards: fp64 shards of 2 and 1 blocks
    "f64_3d_odd_localmesh": ((48, 16, 17), np.float64, 2),
}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(script: Path, nproc: int, tmp: Path, ndev: int, device: str = "cpu"):
    """Start ``nproc`` workers and wait for each with its own timeout; kill
    them all when one expires. Returns (returncode, output) per worker."""
    port = _free_port()
    env = dict(os.environ)
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(nproc), str(port), str(tmp), str(ndev),
                               device],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for i in range(nproc)]
    results = []
    try:
        for p in procs:
            out = p.communicate(timeout=TIMEOUT)[0].decode()
            results.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a worker did not finish within {TIMEOUT} s")
    return results


@pytest.mark.parametrize("case,nproc", [("f32_2d", 2), ("f32_2d", 4), ("f64_3d", 2), ("f32_2d_localmesh", 2),
                                        ("f64_3d_odd_localmesh", 2)])
def test_multihost_bit_exact(tmp_path, case, nproc):
    check_multihost(tmp_path, CASES[case], nproc, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


#: the grids of two processes on the card: a slab's rows, its dtype and its devices on cuda:0
CUDA_CASES = {
    "f32_2d": ((1024, 1030), np.float32, 1),
    "f64_3d": ((128, 128, 129), np.float64, 1),
    "f64_3d_localmesh": ((64, 48, 33), np.float64, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_multihost_bit_exact(tmp_path, cuda, case):
    check_multihost(tmp_path, CUDA_CASES[case], 2, cuda)


def check_multihost(tmp_path, case, nproc, device):
    """``nproc`` workers, each on ``ndev`` of ``device``: the gathered stream
    and the file are golden's, every slab is the input's."""
    rows, dtype, ndev = case
    shape = (rows[0] * nproc,) + rows[1:]
    full = np.random.default_rng(7).standard_normal(shape).astype(dtype)
    full.reshape(-1)[:500] = 0
    np.save(tmp_path / "full.npy", full)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    for i, (rc, out) in enumerate(run_workers(script, nproc, tmp_path, ndev, device)):
        assert rc == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK; foreign modules: []" in out, out[-3000:]

    expect, _ = golden.compress(full)
    assert np.load(tmp_path / "gathered.npy").tobytes() == expect.tobytes(), \
        "gather_stream's stream is not byte for byte the serial stream"
    assert (tmp_path / "stream.ndz").read_bytes() == expect.tobytes(), "compress_to_file's file differs"
    slab_rows = shape[0] // nproc
    for i in range(nproc):
        want = full[i * slab_rows: (i + 1) * slab_rows].tobytes()
        assert np.load(tmp_path / f"slab{i}.npy").tobytes() == want, f"decompress_multihost, process {i}"
        assert np.load(tmp_path / f"file_slab{i}.npy").tobytes() == want, f"decompress_from_file, process {i}"


def test_multihost_refuses_unequal_or_unaligned_slabs(tmp_path):
    """Slabs of different shapes, and a slab whose axis 0 is not whole block
    rows, raise ValueError on every process."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        import torch.distributed as dist
        from ndzip_tpu_torch.parallel import multihost

        pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        multihost.init(f"localhost:{{port}}", nproc, pid)
        for rows in ((64 * (1 + pid), 70), (64 + 1, 70)):
            try:
                multihost.compress_multihost(np.zeros(rows, np.float32), ["cpu"])
            except ValueError as e:
                print(f"refused {{rows}}: {{e}}", flush=True)
        dist.destroy_process_group()
    """))
    for rc, out in run_workers(script, 2, tmp_path, 1):
        assert rc == 0, out[-3000:]
        assert out.count("refused") == 2, out[-3000:]


def test_default_devices_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost._local_mesh(None)
    assert multihost._local_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
