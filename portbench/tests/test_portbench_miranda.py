"""The ``miranda.device`` cell: SDRBench's Miranda snapshot, fp64 3D, which
runs B6/B8. On the CPU the program's plain versions stand in for the card,
with the configuration cut to small fp64 3D shapes here (``conftest.TINY``
holds the other configurations): one without a border, Miranda's grid in
proportion, and one with a border on every axis and an odd block count, so
that the fp64 header has its pad entry. Marked ``cuda``: the cut cell on the
card."""

import json
import types

import pytest
import torch

from cellchecks import E2E, SHARED_READERS, check_entry_metrics  # the checks every cell shares

import ndzip_tpu_torch
from portbench import control, harness, tracing

CELL, CONFIG = "miranda.device", "miranda_f64_3d"
#: the cut shapes, 3 fields each
SHAPES = {"no_border": [32, 48, 48], "borders": [49, 56, 50]}
READERS = [f"{m}.fp64.{d}" for m in ("kernel_roofline_pct", "device_ops_per_call")
           for d in ("compress", "decompress")]


@pytest.fixture(params=list(SHAPES))
def root(tiny_root, request):
    cfg = harness.load_config(CONFIG)
    cfg.update(shape=SHAPES[request.param], fields=3)
    (tiny_root / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    return tiny_root


def _cell(bench):
    return {w["name"]: w for w in bench["workloads"]}[CELL]


def test_the_cut_shapes_are_what_they_claim():
    from ndzip_tpu_torch import format as fmt

    assert fmt.border_element_count(tuple(SHAPES["no_border"])) == 0
    assert fmt.num_hypercubes(tuple(SHAPES["no_border"])) % 2 == 0
    assert all(s % 16 for s in SHAPES["borders"]) and fmt.num_hypercubes(tuple(SHAPES["borders"])) % 2 == 1


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_sound_run_is_correct(bench, root, trace):
    r = harness.run_cell(bench, _cell(bench), 2**31 + 101, 0.3, trace, "cpu", ndzip_tpu_torch, root=root)
    assert r.correct and r.failed == 0 and r.attempted >= 6
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r.checks.values())
    assert 0 < r.ratio < 1  # the sinusoids and their noise compress
    if trace:  # no codec kernel on the CPU: the fp64 metrics are left out, not 0
        assert not set(READERS) & set(r.metrics)
    else:
        assert E2E == set(r.metrics)


@pytest.mark.parametrize("seed", [1, 2**32 + 17])
def test_the_control_is_not_correct(bench, root, seed):
    """The reference on each field rounded to float32, in the program's
    place. Its streams keep their lengths: a block's low bit planes stay
    nonzero, since complement-negative sets the low bits of every negative
    residual, so the words tell it apart and the lengths do not."""
    cell = _cell(bench)
    factory = control.control_factory(harness.load_mix(cell["traffic"], root))
    r = harness.run_cell(bench, cell, seed, 0.3, False, "cpu", ndzip_tpu_torch, root=root, entry_factory=factory)
    assert not r.correct
    for name in ("stream_words_differing", "field_words_differing"):
        assert r.checks[name]["value"] > 0


def _flipping(where):
    """The program with one bit flipped in the middle word of every stream
    (``compress``) or of every field given back (``decompress``)."""

    def flip(t):
        t = t.clone()
        flat = t.view(torch.int64 if t.element_size() == 8 else torch.int32).reshape(-1)
        flat[flat.numel() // 2] ^= 1 << 7
        return t

    def compress_device(x):
        stream, length = ndzip_tpu_torch.compress_device(x)
        return (flip(stream[: int(length)]) if where == "compress" else stream), length

    def decompress_device(stream, shape, dtype):
        out = ndzip_tpu_torch.decompress_device(stream, shape, dtype)
        return flip(out) if where == "decompress" else out

    return types.SimpleNamespace(compress_device=compress_device, decompress_device=decompress_device)


@pytest.mark.parametrize("where", ["compress", "decompress"], ids=["stream_word", "field_word"])
def test_one_flipped_bit_is_not_correct(bench, root, where):
    r = harness.run_cell(bench, _cell(bench), 13, 0.3, False, "cpu", _flipping(where), root=root)
    assert not r.correct
    differing = "stream_words_differing" if where == "compress" else "field_words_differing"
    assert r.checks[differing]["value"] > 0


def test_the_benchmark_entry(bench):
    cell = _cell(bench)
    assert cell == {"name": CELL, "config": CONFIG, "traffic": "device", "chips": 1, "why": cell["why"]}
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == [] and entry["file"] == f"portbench/configs/{CONFIG}.json"
    cfg = harness.load_config(CONFIG)
    assert cfg["shape"] == [256, 384, 384] and cfg["dtype"] == "float64" and cfg["fields"] == 7
    assert cfg["reduced"] == [] and cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    check_entry_metrics(bench, CELL, READERS, "csrc kernels (B6, B8)")


def _record(kernels):
    """A traced record of one compress call (a memset, each kernel of
    ``kernels``, the length's copy) and one decompress call (each kernel)."""
    def ops(names, t0):
        return [tracing.Op(n, cat, t0 + i * 1e-4, t0 + (i + 1) * 1e-4)
                for i, (n, cat) in enumerate(names)]

    c = ops([("Memset (Device)", "gpu_memset")] + [(k, "kernel") for k in kernels]
            + [("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy")], 0.0)
    d = ops([(k, "kernel") for k in kernels], 1.0)
    calls = [tracing.TracedCall("compress", 10**8, 0.0, 0.5, c), tracing.TracedCall("decompress", 10**8, 1.0, 1.5, d)]
    return tracing.Record(calls, c + d, (0.0, 1.5), 3.35e12)


B6, B8 = "void encode_blocks64_nd<3>(...)", "void decode_blocks64_nd<3>(...)"


@pytest.mark.parametrize("kernels", [[], ["void encode_blocks_nd<3>(...)"], ["void decode_blocks_nd<2>(...)"],
                                     ["void encode_blocks64(...)"], [B6, "void encode_blocks_nd<3>(...)"]],
                         ids=["no_codec_kernel", "b3", "b4", "b5", "b6_and_b3"])
@pytest.mark.parametrize("name", READERS)
def test_the_fp64_readers_find_nothing_but_b6_and_b8(tiny_root, name, kernels):
    assert harness.load_reader("metrics", name, tiny_root)(_record(kernels)) is None


@pytest.mark.parametrize("name", READERS)
def test_the_fp64_readers_read_b6_and_b8(tiny_root, name):
    rec = _record([B6, B8])
    value = harness.load_reader("metrics", name, tiny_root)(rec)
    direction = name.rsplit(".", 1)[1]
    plain = "kernel_roofline_pct" if name.startswith("kernel_roofline") else "device_ops_per_call"
    assert value == harness.load_reader("metrics", f"{plain}.{direction}", tiny_root)(rec) and value > 0


@pytest.mark.cuda
def test_the_cut_cell_on_the_card(bench, root, cuda):
    from ndzip_tpu_torch import codec_cuda

    for k in codec_cuda.COPIES:
        codec_cuda.COPIES[k] = 0
    for trace in (False, True):
        r = harness.run_cell(bench, _cell(bench), 2**31 + 7, 0.5, trace, cuda, ndzip_tpu_torch, root=root)
        assert r.correct, r.checks
        if trace:
            assert set(READERS) | set(SHARED_READERS) <= set(r.metrics) and r.device["busy_s"] > 0
            assert 0 < r.metrics["kernel_roofline_pct.fp64.compress"]["value"] <= 105
    assert not any(codec_cuda.COPIES.values())
