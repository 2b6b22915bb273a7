"""The ``hacc.device`` cell: SDRBench's HACC snapshot, 6 1D fp32 arrays of
280,953,867 floats, which runs B1/B2. On the CPU the program's plain
versions stand in for the card, with the configuration cut to small 1D
lengths here (``conftest.TINY`` holds the other configurations), the
formula's step kept at 1e-4 an element: one length of whole blocks, and one
of HACC's structure, an even block count and a border of 1,035 elements.
Marked ``cuda``: the cut cell on the card."""

import json

import pytest
from cellchecks import E2E, SHARED_READERS, check_entry_metrics, check_ops_a_call  # the checks every cell shares
from test_portbench_msg_bt import _flipping, _record  # the same stream, field and trace doubles

import ndzip_tpu_torch
from ndzip_tpu_torch import format as fmt
from portbench import control, harness

CELL, CONFIG = "hacc.device", "hacc_f32_1d"
#: the cut lengths, 3 fields each
LENGTHS = {"no_border": 4 * 4096, "border": 6 * 4096 + 1035}
READERS = [f"{m}.fp32_1d.{d}" for m in ("kernel_roofline_pct", "device_ops_per_call")
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


def test_the_published_length_has_haccs_structure():
    shape = tuple(harness.load_config(CONFIG)["shape"])
    assert shape == (280953867,)
    assert (fmt.num_hypercubes(shape), fmt.border_element_count(shape)) == (68592, 1035)
    assert fmt.num_hypercubes(shape) % 2 == 0 and fmt.header_words(68592, 32) == 68592  # no pad entry
    assert fmt.compressed_bound_u32(shape, 32) == 289802235 < 2**31


def test_the_cut_lengths_are_what_they_claim():
    n0, n1 = LENGTHS["no_border"], LENGTHS["border"]
    assert fmt.border_element_count((n0,)) == 0 and fmt.num_hypercubes((n0,)) == 4
    assert fmt.border_element_count((n1,)) == 1035 and fmt.num_hypercubes((n1,)) == 6


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_sound_run_is_correct(bench, root, trace):
    r = harness.run_cell(bench, _cell(bench), 2**31 + 101, 0.3, trace, "cpu", ndzip_tpu_torch, root=root)
    assert r.correct and r.failed == 0 and r.attempted >= 6
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r.checks.values())
    assert 0 < r.ratio < 1  # the sinusoid and its noise compress
    if trace:  # no codec kernel on the CPU: the fp32 1D metrics are left out, not 0
        assert not set(READERS) & set(r.metrics)
    else:
        assert E2E == set(r.metrics)


@pytest.mark.parametrize("seed", [3, 2**32 + 19])
def test_the_control_is_not_correct(bench, root, seed):
    """The reference on each field rounded to bfloat16, in the program's
    place: its words differ from the program's."""
    cell = _cell(bench)
    factory = control.control_factory(harness.load_mix(cell["traffic"], root))
    r = harness.run_cell(bench, cell, seed, 0.3, False, "cpu", ndzip_tpu_torch, root=root, entry_factory=factory)
    assert not r.correct
    for name in ("stream_words_differing", "field_words_differing"):
        assert r.checks[name]["value"] > 0


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
    assert cfg["shape"] == [280953867] and cfg["dtype"] == "float32" and cfg["fields"] == 6
    assert cfg["reduced"] == [] and cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    (axis,) = cfg["formula"]["axes"]  # bench.py's main-path formula: sin(i * 1e-4) + 1e-3 N(0, 1)
    assert axis["fn"] == "sin" and axis["span"] == pytest.approx(280953867 * 1e-4) and cfg["formula"]["noise"] == 1e-3
    check_entry_metrics(bench, CELL, READERS, "csrc kernels (B1, B2)")


B1 = "ndzip::encode_blocks(unsigned int const*, unsigned long, unsigned long, unsigned long*, unsigned int*, int*)"
B2 = "ndzip::decode_blocks(unsigned int const*, unsigned long, unsigned long, unsigned long, ndzip::Border, unsigned int*)"
OTHERS = {"b3": "void ndzip::encode_blocks_nd<3>(...)", "b3_box": "ndzip::encode_blocks_nd_box(CUtensorMap, ...)",
          "b4": "void ndzip::decode_blocks_nd<2>(...)", "b4_box": "ndzip::decode_blocks_nd_box(CUtensorMap, ...)",
          "b5": "ndzip::encode_blocks64(unsigned long long const*, ...)",
          "b6": "void ndzip::encode_blocks64_nd<3>(...)",
          "b7": "ndzip::decode_blocks64(unsigned int const*, ...)", "b8": "void ndzip::decode_blocks64_nd<2>(...)"}


@pytest.mark.parametrize("kernels", [[], *([k] for k in OTHERS.values()), [B1, OTHERS["b3"]], [B2, OTHERS["b7"]]],
                         ids=["no_codec_kernel", *OTHERS, "b1_and_b3", "b2_and_b7"])
@pytest.mark.parametrize("name", READERS)
def test_the_fp32_1d_readers_find_nothing_but_b1_and_b2(tiny_root, name, kernels):
    assert harness.load_reader("metrics", name, tiny_root)(_record(kernels)) is None


@pytest.mark.parametrize("name", READERS)
def test_the_fp32_1d_readers_read_b1_and_b2(tiny_root, name):
    rec = _record([B1], [B2])
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
            for d in ("compress", "decompress"):
                assert 0 < r.metrics[f"kernel_roofline_pct.fp32_1d.{d}"]["value"] <= 105
            check_ops_a_call(r, 3, 1)
    assert not any(codec_cuda.COPIES.values())
    assert {k for k, n in codec_cuda.LAUNCHES.items() if n} == {"encode", "decode"}
