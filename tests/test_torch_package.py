"""The port's package as a whole: it imports no JAX, its kernel build has no
fallback, its CUDA entry points refuse CPU tensors, and fp64, which the port
does not cover yet, raises NotImplementedError in 1-3 dims."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu_torch import _build, codec_cuda  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["ndzip_tpu_torch", "ndzip_tpu_torch._build", "ndzip_tpu_torch.codec_cuda",
           "ndzip_tpu_torch.codec_torch", "ndzip_tpu_torch.interop", "ndzip_tpu_torch.ops.bitops"]


def test_import_leaves_jax_out():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for src in (ROOT / "ndzip_tpu_torch").rglob("*.py"):
        assert "import jax" not in src.read_text(), src


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "libndzip_cuda_test.so")
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert list(tmp_path.iterdir()) == []


def test_failing_nvcc_raises_with_its_stderr(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: kernel does not compile' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "build" / "libndzip_cuda_test.so")
    with pytest.raises(RuntimeError, match="kernel does not compile"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_cuda_entry_points_refuse_cpu_tensors():
    before = dict(codec_cuda.LAUNCHES)
    x = torch.zeros(4096 * 2)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.compress_device(x)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_blocks_fp32(x.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.decompress_device(torch.zeros(10, dtype=torch.int32), (4096 * 2,))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_blocks_fp32(torch.zeros(10, dtype=torch.int32), 4096 * 2)
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.compress_device(torch.zeros(64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._encode_interior_fp32(torch.zeros(16, 16, 16, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda.decompress_device(torch.zeros(10, dtype=torch.int32), (64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        codec_cuda._decode_interior_fp32(torch.zeros(10, dtype=torch.int32), (16, 16, 16))
    assert codec_cuda.LAUNCHES == before


@pytest.mark.parametrize("shape", [(4096,), (64, 64), (16, 16, 16)], ids=["fp64", "2d", "3d"])
def test_other_profiles_are_not_implemented(shape):
    """fp64 in 1, 2 and 3 dims (ROADMAP Queue 1 item 6)."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        nt.compress_device(torch.zeros(shape, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        nt.decompress_device(torch.zeros(10, dtype=torch.int32), shape, np.float64)


def test_bad_inputs_raise_value_error():
    with pytest.raises(ValueError):
        nt.compress_device(torch.zeros(10, dtype=torch.float16))
    with pytest.raises(ValueError):
        nt.compress_device(torch.zeros(2, 2, 2, 2))
    with pytest.raises(ValueError):
        nt.decompress_device(torch.zeros(10, dtype=torch.int32), (10,), np.float16)
