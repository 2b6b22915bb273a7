"""The port's observability utilities (``ndzip_tpu_torch.utils``): the cases
of tests/test_utils.py that apply to the port (the verbose gate under
``NDZIP_TORCH_VERBOSE``, ``log``, ``trace``'s ``[profile]`` line), and a
``profiler_trace`` around a ``trace`` span that writes a trace holding the
span's label (reference: common.hh:630-633, sycl_bits.hh:38-55)."""

import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import utils  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_gate():
    utils.verbose.cache_clear()
    yield
    utils.verbose.cache_clear()


def test_verbose_gate(monkeypatch, capsys):
    monkeypatch.setenv("NDZIP_TORCH_VERBOSE", "1")
    assert utils.verbose() is True
    utils.log("hello", 3)
    assert "[ndzip-torch] hello 3" in capsys.readouterr().err

    for off in ("0", "false", "no", ""):
        utils.verbose.cache_clear()
        monkeypatch.setenv("NDZIP_TORCH_VERBOSE", off)
        assert utils.verbose() is False
        utils.log("quiet")
        assert capsys.readouterr().err == ""


def test_verbose_is_read_once(monkeypatch):
    monkeypatch.delenv("NDZIP_TORCH_VERBOSE", raising=False)
    assert utils.verbose() is False
    monkeypatch.setenv("NDZIP_TORCH_VERBOSE", "1")
    assert utils.verbose() is False  # cached until the cache is cleared
    assert utils.VERBOSE_ENV == "NDZIP_TORCH_VERBOSE"


def test_trace_prints_under_verbose(monkeypatch, capsys):
    monkeypatch.setenv("NDZIP_TORCH_VERBOSE", "1")
    with utils.trace("unit-test-region"):
        torch.ones(64).sum()
    err = capsys.readouterr().err
    assert "[profile] unit-test-region" in err and err.strip().endswith("ms")


def test_trace_is_silent_without_verbose(monkeypatch, capsys):
    monkeypatch.delenv("NDZIP_TORCH_VERBOSE", raising=False)
    with utils.trace("quiet-region"):
        pass
    assert capsys.readouterr().err == ""


def test_profiler_trace_writes_the_span_labels(tmp_path):
    with utils.profiler_trace(tmp_path) as prof:
        with utils.trace("ndzip-unit-span"):
            torch.arange(4096, dtype=torch.int32).cumsum(0)
        with utils.trace("ndzip-second-span"):
            torch.ones(16).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    text = files[0].read_text()
    assert "ndzip-unit-span" in text and "ndzip-second-span" in text
    assert any(e.key == "ndzip-unit-span" for e in prof.key_averages())
