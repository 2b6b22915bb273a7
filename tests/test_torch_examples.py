"""The port's walkthroughs (examples/torch/) must stay runnable: each runs
with ``--cpu``, the plain PyTorch path, as a subprocess and prints ``OK``,
as tests/test_examples.py does for the JAX package's. Without ``--cpu`` and
without a GPU each stops with an error instead of falling back; on a card
(marker ``cuda``) the device-resident walkthrough runs there."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ["01_roundtrip.py", "02_device_resident.py", "03_sharded_mesh.py", "04_file_streams.py",
           "05_serving_path.py"]


def test_every_walkthrough_is_listed():
    assert sorted(p.name for p in (REPO / "examples" / "torch").glob("*.py")) == SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_the_cpu(script):
    res = subprocess.run([sys.executable, str(REPO / "examples" / "torch" / script), "--cpu"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK"


def test_example_without_a_gpu_does_not_fall_back():
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = [sys.argv[1]]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code, str(REPO / "examples" / "torch" / "02_device_resident.py")],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode != 0 and "OK" not in res.stdout
    assert "pass --cpu" in res.stderr


@pytest.mark.cuda
def test_cuda_device_resident_example_runs_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run([sys.executable, str(REPO / "examples" / "torch" / "02_device_resident.py")],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "OK"
