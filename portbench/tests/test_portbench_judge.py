"""The comparison that decides ``correct``: sound runs pass, and the control
and each fault the cells can have, planted under the timed path, fail.

The harness runs on the CPU here with its look for a chip skipped: the
program's CPU path (its plain versions) stands in for the card, at the
sizes of ``conftest.TINY``."""

import types

import numpy as np
import pytest
import torch

import ndzip_tpu_torch
from portbench import control, harness

CELLS = ["magrecon.device", "cesm.fields", "magrecon.offload", "cesm.offload"]
#: cells of the ``offload`` mix, kept ready for when the host path is steady enough to bound
OFFLOAD = {f"{c}.offload": {"name": f"{c}.offload", "config": cfg, "traffic": "offload", "chips": 1, "why": "test"}
           for c, cfg in (("magrecon", "magrecon_f32_3d"), ("cesm", "cesm_atm_f32_2d"))}


def _cell(bench, name):
    return {w["name"]: w for w in bench["workloads"]}.get(name) or OFFLOAD[name]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(bench, tiny_root, name):
    r = harness.run_cell(bench, _cell(bench, name), 2**31 + 99, 0.3, False, "cpu", ndzip_tpu_torch, root=tiny_root)
    assert r.correct and r.failed == 0 and r.attempted >= 6  # at least the window's first sweep over 3 fields
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r.checks.values())
    assert list(r.checks) == ["length_mismatches", "stream_words_differing", "field_words_differing",
                              "fields_unchecked"]


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**32 + 17])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(bench, tiny_root, name, seed):
    """The reference a precision below the configuration's, in the
    program's place: lossy, so every number it reads is far from 0."""
    cell = _cell(bench, name)
    factory = control.control_factory(harness.load_mix(cell["traffic"], tiny_root))
    r = harness.run_cell(bench, cell, seed, 0.3, False, "cpu", ndzip_tpu_torch, root=tiny_root,
                         entry_factory=factory)
    assert not r.correct
    for name in ("length_mismatches", "stream_words_differing", "field_words_differing"):
        assert r.checks[name]["value"] > 0


class _Fault:
    """The program with one fault planted where an answer is produced:
    ``stale`` gives back the previous call's answer (a step that returns its
    state unchanged), ``half`` leaves out the second half of the field, and
    ``altered`` flips one bit of one word. ``where`` is the direction."""

    def __init__(self, kind, where):
        self.kind, self.where, self.last = kind, where, None

    def _break(self, words: torch.Tensor) -> torch.Tensor:
        if self.kind == "stale":
            out, self.last = (words if self.last is None else self.last), words.clone()
            return out
        words = words.clone()
        flat = words.reshape(-1)
        if self.kind == "half":
            flat[flat.numel() // 2:] = 0
        else:
            flat[flat.numel() // 2] ^= 1
        return words

    def compress_device(self, x):
        if self.where == "compress" and self.kind == "half":
            x = self._break(x.view(torch.int32)).view(x.dtype)
        stream, length = ndzip_tpu_torch.compress_device(x)
        if self.where == "compress" and self.kind != "half":
            stream = self._break(stream[: int(length)])
        return stream, length

    def decompress_device(self, stream, shape, dtype):
        out = ndzip_tpu_torch.decompress_device(stream, shape, dtype)
        if self.where == "decompress":
            out = self._break(out.view(torch.int32)).view(dtype)
        return out

    def Offloader(self, dtype, dims, backend):
        fault = self

        class Offloader:
            def __init__(self):
                self.inner = ndzip_tpu_torch.Offloader(dtype, dims, backend=backend)

            def compress(self, data):
                t = torch.from_numpy(data).view(torch.int32)
                if fault.where == "compress" and fault.kind == "half":
                    data = fault._break(t).numpy().view(data.dtype)
                stream, words = self.inner.compress(data)
                if fault.where == "compress" and fault.kind != "half":
                    stream = fault._break(torch.from_numpy(stream.view(np.int32))).numpy().view(np.uint32)
                return stream, words

            def decompress(self, stream, shape):
                out = self.inner.decompress(stream, shape)
                if fault.where == "decompress":
                    out = fault._break(torch.from_numpy(out).view(torch.int32)).numpy().view(out.dtype)
                return out

        return Offloader()


@pytest.mark.parametrize("where", ["compress", "decompress"])
@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", ["magrecon.device", "cesm.offload"])
def test_a_fault_under_the_timed_path_is_not_correct(bench, tiny_root, name, kind, where):
    program = types.SimpleNamespace()
    fault = _Fault(kind, where)
    program.compress_device, program.decompress_device = fault.compress_device, fault.decompress_device
    program.Offloader = fault.Offloader
    r = harness.run_cell(bench, _cell(bench, name), 11, 0.3, False, "cpu", program, root=tiny_root)
    assert not r.correct, r.checks


def test_a_call_that_raises_ends_the_window_not_correct(bench, tiny_root):
    def boom(*args):
        raise RuntimeError("planted")

    program = types.SimpleNamespace(compress_device=ndzip_tpu_torch.compress_device, decompress_device=boom)
    r = harness.run_cell(bench, _cell(bench, "cesm.fields"), 5, 0.3, False, "cpu", program, root=tiny_root)
    assert not r.correct and r.failed == 1 and r.checks["fields_unchecked"]["value"] > 0


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(bench, tiny_root, cuda):
    for name in CELLS:
        for trace in (False, True):
            r = harness.run_cell(bench, _cell(bench, name), 3, 0.5, trace, cuda, ndzip_tpu_torch, root=tiny_root)
            assert r.correct, (name, r.checks)
            if trace:  # the per-layer metrics name the benchmark's cells, not the offload ones kept ready
                assert r.device["busy_s"] > 0
                assert ("device_ops_per_call.compress" in r.metrics) == (name not in OFFLOAD)
