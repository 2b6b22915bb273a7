"""Tests of the benchmark harness. They run on the CPU, with the program's
plain versions in place of the card; those marked ``cuda`` skip without a
CUDA device. Run: ``python -m pytest portbench/tests -q``."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PKG = ROOT / "portbench"
#: the configurations cut to a size a test run holds, each with borders
TINY = {"magrecon_f32_3d": ([33, 40, 50], 3), "cesm_atm_f32_2d": ([130, 200], 3)}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's data files and readers with the
    configurations cut to ``TINY``."""
    for folder in ("traffic", "metrics", "endtoend", "entries"):
        shutil.copytree(PKG / folder, tmp_path / folder, ignore=shutil.ignore_patterns("__pycache__"))
    for mix in (tmp_path / "traffic").glob("*.json"):  # no clocks to bring up on the CPU
        mix.write_text(json.dumps(dict(json.loads(mix.read_text()), warm_seconds=0.0)))
    (tmp_path / "configs").mkdir()
    for name, (shape, fields) in TINY.items():
        cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
        cfg.update(shape=shape, fields=fields)
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return tmp_path
