"""The ``msg_bt.device`` cell: ndzip's registry set msg_bt, one 1D fp64 array
of 33,298,679 doubles, which runs B5/B7. On the CPU the program's plain
versions stand in for the card, with the configuration cut to small 1D
lengths here (``conftest.TINY`` holds the other configurations), the
formula's step kept at 1e-4 an element: one length of whole blocks with an
even count, and one of msg_bt's structure, an odd block count (so the fp64
header has its pad entry) and a border of 2,295 elements. Marked ``cuda``:
the cut cell on the card."""

import json
import types

import pytest
import torch
from cellchecks import E2E, SHARED_READERS, check_entry_metrics, check_ops_a_call  # the checks every cell shares

import ndzip_tpu_torch
from ndzip_tpu_torch import format as fmt
from portbench import control, harness, tracing

CELL, CONFIG = "msg_bt.device", "msg_bt_f64_1d"
#: the cut lengths, 3 fields each
LENGTHS = {"no_border": 4 * 4096, "border": 3 * 4096 + 2295}
READERS = [f"{m}.fp64_1d.{d}" for m in ("kernel_roofline_pct", "device_ops_per_call")
           for d in ("compress", "decompress")]
@pytest.fixture(params=list(LENGTHS))
def root(tiny_root, request):
    n = LENGTHS[request.param]
    cfg = harness.load_config(CONFIG)
    (axis,) = cfg["formula"]["axes"]
    cfg.update(shape=[n], fields=3, formula=dict(cfg["formula"], axes=[dict(axis, span=n * 1e-4)]))
    (tiny_root / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    return tiny_root


def _cell(bench):
    return {w["name"]: w for w in bench["workloads"]}[CELL]


def test_the_published_length_has_msg_bts_structure():
    shape = tuple(harness.load_config(CONFIG)["shape"])
    assert shape == (33298679,)
    assert (fmt.num_hypercubes(shape), fmt.border_element_count(shape)) == (8129, 2295)
    assert fmt.header_words(8129, 64) * 2 == 8129 + 1  # the u32 offsets and the zero pad entry


def test_the_cut_lengths_are_what_they_claim():
    n0, n1 = LENGTHS["no_border"], LENGTHS["border"]
    assert fmt.border_element_count((n0,)) == 0 and fmt.num_hypercubes((n0,)) % 2 == 0
    assert fmt.border_element_count((n1,)) == 2295 and fmt.num_hypercubes((n1,)) % 2 == 1


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_sound_run_is_correct(bench, root, trace):
    r = harness.run_cell(bench, _cell(bench), 2**31 + 101, 0.3, trace, "cpu", ndzip_tpu_torch, root=root)
    assert r.correct and r.failed == 0 and r.attempted >= 6
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r.checks.values())
    assert 0 < r.ratio < 1  # the sinusoid and its noise compress
    if trace:  # no codec kernel on the CPU: the fp64 1D metrics are left out, not 0
        assert not set(READERS) & set(r.metrics)
    else:
        assert E2E == set(r.metrics)


@pytest.mark.parametrize("seed", [3, 2**32 + 19])
def test_the_control_is_not_correct(bench, root, seed):
    """The reference on each field rounded to float32, in the program's
    place: its words differ from the program's."""
    cell = _cell(bench)
    factory = control.control_factory(harness.load_mix(cell["traffic"], root))
    r = harness.run_cell(bench, cell, seed, 0.3, False, "cpu", ndzip_tpu_torch, root=root, entry_factory=factory)
    assert not r.correct
    for name in ("stream_words_differing", "field_words_differing"):
        assert r.checks[name]["value"] > 0


def _flipping(where):
    """The program with one bit flipped in every stream (``compress``: the
    middle word; ``border``: the last, a border word where the field has a
    border) or in the middle word of every field given back
    (``decompress``)."""

    def flip(t, at):
        t = t.clone()
        flat = t.view(torch.int64 if t.element_size() == 8 else torch.int32).reshape(-1)
        flat[at(flat.numel())] ^= 1 << 7
        return t

    def compress_device(x):
        stream, length = ndzip_tpu_torch.compress_device(x)
        at = {"compress": lambda k: k // 2, "border": lambda k: k - 1}.get(where)
        return (stream if at is None else flip(stream[: int(length)], at)), length

    def decompress_device(stream, shape, dtype):
        out = ndzip_tpu_torch.decompress_device(stream, shape, dtype)
        return flip(out, lambda k: k // 2) if where == "decompress" else out

    return types.SimpleNamespace(compress_device=compress_device, decompress_device=decompress_device)


@pytest.mark.parametrize("where", ["compress", "border", "decompress"],
                         ids=["stream_word", "stream_tail_word", "field_word"])
def test_one_flipped_bit_is_not_correct(bench, root, where):
    r = harness.run_cell(bench, _cell(bench), 17, 0.3, False, "cpu", _flipping(where), root=root)
    assert not r.correct
    differing = "field_words_differing" if where == "decompress" else "stream_words_differing"
    assert r.checks[differing]["value"] > 0


def test_the_benchmark_entry(bench):
    cell = _cell(bench)
    assert cell == {"name": CELL, "config": CONFIG, "traffic": "device", "chips": 1, "why": cell["why"]}
    (entry,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == [] and entry["file"] == f"portbench/configs/{CONFIG}.json"
    cfg = harness.load_config(CONFIG)
    assert cfg["shape"] == [33298679] and cfg["dtype"] == "float64" and cfg["fields"] == 1
    assert cfg["reduced"] == [] and cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    check_entry_metrics(bench, CELL, READERS, "csrc kernels (B5, B7)")


def _record(kernels, decode_kernels=None):
    """A traced record of one compress call (a memset, each kernel of
    ``kernels``, the length's copy) and one decompress call (each kernel of
    ``decode_kernels``, by default ``kernels``)."""
    def ops(names, t0):
        return [tracing.Op(n, cat, t0 + i * 1e-4, t0 + (i + 1) * 1e-4)
                for i, (n, cat) in enumerate(names)]

    c = ops([("Memset (Device)", "gpu_memset")] + [(k, "kernel") for k in kernels]
            + [("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy")], 0.0)
    d = ops([(k, "kernel") for k in (kernels if decode_kernels is None else decode_kernels)], 1.0)
    calls = [tracing.TracedCall("compress", 10**8, 0.0, 0.5, c), tracing.TracedCall("decompress", 10**8, 1.0, 1.5, d)]
    return tracing.Record(calls, c + d, (0.0, 1.5), 3.35e12)


B5 = "encode_blocks64(unsigned long long const*, unsigned long, unsigned long, unsigned long*, unsigned int*, int*)"
B7 = "decode_blocks64(unsigned int const*, unsigned long, unsigned long, Border, unsigned long long*)"
OTHERS = {"b1": "encode_blocks(unsigned int const*, ...)", "b2": "decode_blocks(unsigned int const*, ...)",
          "b3": "void encode_blocks_nd<3>(...)", "b3_box": "encode_blocks_nd_box(CUtensorMap, ...)",
          "b4": "void decode_blocks_nd<2>(...)", "b6": "void encode_blocks64_nd<3>(...)",
          "b8": "void decode_blocks64_nd<2>(...)"}


@pytest.mark.parametrize("kernels", [[], *([k] for k in OTHERS.values()), [B5, OTHERS["b6"]], [B7, OTHERS["b1"]]],
                         ids=["no_codec_kernel", *OTHERS, "b5_and_b6", "b7_and_b1"])
@pytest.mark.parametrize("name", READERS)
def test_the_fp64_1d_readers_find_nothing_but_b5_and_b7(tiny_root, name, kernels):
    assert harness.load_reader("metrics", name, tiny_root)(_record(kernels)) is None


@pytest.mark.parametrize("name", READERS)
def test_the_fp64_1d_readers_read_b5_and_b7(tiny_root, name):
    rec = _record([B5], [B7])
    value = harness.load_reader("metrics", name, tiny_root)(rec)
    direction = name.rsplit(".", 1)[1]
    plain = "kernel_roofline_pct" if name.startswith("kernel_roofline") else "device_ops_per_call"
    assert value == harness.load_reader("metrics", f"{plain}.{direction}", tiny_root)(rec) and value > 0
    if plain == "device_ops_per_call":
        assert value == {"compress": 3, "decompress": 1}[direction]


@pytest.mark.cuda
def test_the_cut_cell_on_the_card(bench, root, cuda):
    from ndzip_tpu_torch import codec_cuda

    for counter in (codec_cuda.COPIES, codec_cuda.LAUNCHES):
        for k in counter:
            counter[k] = 0
    for trace in (False, True):
        r = harness.run_cell(bench, _cell(bench), 2**31 + 7, 0.5, trace, cuda, ndzip_tpu_torch, root=root)
        assert r.correct, r.checks
        if trace:
            assert set(READERS) | set(SHARED_READERS) <= set(r.metrics) and r.device["busy_s"] > 0
            assert 0 < r.metrics["kernel_roofline_pct.fp64_1d.compress"]["value"] <= 105
            check_ops_a_call(r, 3, 1)
    assert not any(codec_cuda.COPIES.values())
    assert {k for k, n in codec_cuda.LAUNCHES.items() if n} == {"encode64", "decode64"}
