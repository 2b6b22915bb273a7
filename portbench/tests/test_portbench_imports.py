"""What the benchmark may import, read from its syntax trees, and its refusal
to run without a card."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ndzip_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN  # whole top-level names: ndzip_tpu_torch is allowed


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "numpy", "torch", "collections", "dataclasses"}


def test_the_top_level_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import ndzip_tpu_torch.api\nfrom ndzip_tpu_torch import golden\nimport jax.numpy\n")
    assert _imports(probe) & FORBIDDEN == {"jax"}


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cesm.fields", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == "" and "CUDA" in proc.stderr


def test_an_unknown_workload_fails():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nope", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
