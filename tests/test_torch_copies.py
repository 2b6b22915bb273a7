"""``codec_cuda.COPIES``: the copies the device API makes of a caller's
tensor before a launch, by cause, each inside an ``ndzip.copy_in`` span. On
a card (marker ``cuda``): an fp64 stream at an odd u32 offset is realigned
once, a 1D input at a 16-byte misalignment and a non-contiguous input are
copied once each, and aligned, contiguous calls (those of the benchmark's
``miranda.device`` and ``msg_bt.device`` cells among them) copy nothing."""

import json

import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import codec_cuda, codec_torch, utils  # noqa: E402

NONE = {"realign64": 0, "align1d": 0, "contiguous": 0}


def _reset():
    for k in codec_cuda.COPIES:
        codec_cuda.COPIES[k] = 0


def test_the_copies_counter_has_its_three_causes_at_zero_after_a_reset():
    codec_cuda.COPIES["contiguous"] += 1
    _reset()
    assert codec_cuda.COPIES == NONE


def _span_names(log_dir) -> list:
    """The names of the spans in the one trace ``utils.profiler_trace`` wrote, by start."""
    (path,) = list(log_dir.glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted((e for e in events if e.get("ph") == "X"
                                       and e.get("cat") == "user_annotation"), key=lambda e: (e["ts"], -e["dur"]))]


@pytest.mark.parametrize("cause", sorted(NONE))
def test_a_copy_is_counted_by_its_cause_inside_its_span(tmp_path, cause):
    t = torch.arange(12, dtype=torch.int64).reshape(3, 4).t()
    _reset()
    with utils.profiler_trace(tmp_path):
        out = codec_cuda._copy_in(cause, t.contiguous)
    assert out.is_contiguous() and torch.equal(out, t)
    assert codec_cuda.COPIES == dict(NONE, **{cause: 1})
    assert _span_names(tmp_path) == ["ndzip.copy_in"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _compressed(x):
    stream, length = codec_cuda.compress_device(x)
    n = int(length)
    return stream[:n], n


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3 * 4096 + 77,), (130, 200), (49, 56, 50)], ids=["1d", "2d", "3d"])
def test_an_fp64_stream_at_an_odd_u32_offset_is_realigned_once(cuda, shape):
    x = torch.randn(shape, dtype=torch.float64, device=cuda)
    stream, n = _compressed(x)
    buf = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    buf[1:] = stream
    _reset()
    out = codec_cuda.decompress_device(buf[1:], shape, torch.float64)
    assert codec_cuda.COPIES == dict(NONE, realign64=1)
    assert torch.equal(_bits(out), _bits(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3 * 4096 + 77,), (32, 48, 48), (49, 56, 50), (256, 384, 384)],
                         ids=["1d", "3d", "3d-borders", "miranda"])
def test_aligned_contiguous_calls_copy_nothing(cuda, shape):
    """The cell's calls (``stream[:length]`` of the compress call, as
    ``portbench/entries/device.py`` makes them, at Miranda's published
    shape too) and a stream slice at an even u32 offset."""
    x = torch.randn(shape, dtype=torch.float64, device=cuda)
    _reset()
    stream, n = _compressed(x)
    out = codec_cuda.decompress_device(stream, shape, torch.float64)
    buf = torch.zeros(n + 2, dtype=torch.int32, device=cuda)
    buf[2:] = stream
    again = codec_cuda.decompress_device(buf[2:], shape, torch.float64)
    assert codec_cuda.COPIES == NONE
    assert torch.equal(_bits(out), _bits(x)) and torch.equal(_bits(again), _bits(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_misaligned_1d_input_is_copied_once(cuda, dtype):
    n = 3 * 4096 + 77
    x = torch.randn(n + 1, dtype=dtype, device=cuda)[1:]
    assert x.data_ptr() % 16
    want, want_n = _compressed(x.clone())
    _reset()
    stream, got_n = _compressed(x)
    assert codec_cuda.COPIES == dict(NONE, align1d=1)
    assert got_n == want_n and torch.equal(stream, want)
    assert torch.equal(_bits(codec_cuda.decompress_device(stream, (n,), dtype)), _bits(x))


#: the length of the benchmark's msg_bt.device field: 8129 blocks and a border of 2295
MSG_BT = 33298679


@pytest.mark.cuda
def test_msg_bt_copies_only_off_alignment(cuda):
    """A field of msg_bt's length, made fresh on the card as the cell makes
    it, goes through one round trip with one B5 and one B7 launch and no
    copy; the same field viewed from its second element (8 B off 16-byte
    alignment) is copied once, and its stream is still the plain
    version's, word for word."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    buf = torch.sin(torch.arange(MSG_BT + 1, dtype=torch.float64, device=cuda) * 1e-4)
    buf.add_(torch.randn(MSG_BT + 1, dtype=torch.float64, device=cuda, generator=gen).mul_(1e-3))
    x = buf[:MSG_BT]
    for counter in (codec_cuda.COPIES, codec_cuda.LAUNCHES):
        for k in counter:
            counter[k] = 0
    stream, n = _compressed(x)
    out = codec_cuda.decompress_device(stream, x.shape, torch.float64)
    assert codec_cuda.COPIES == NONE
    assert {k: v for k, v in codec_cuda.LAUNCHES.items() if v} == {"encode64": 1, "decode64": 1}
    assert torch.equal(_bits(out), _bits(x))
    del out, stream
    view = buf[1:]
    assert view.data_ptr() % 16 == 8
    stream, n = _compressed(view)
    assert codec_cuda.COPIES == dict(NONE, align1d=1)
    plain, plain_n = codec_torch.encode(codec_torch.as_words(view))
    assert int(plain_n) == n and torch.equal(plain[:n], stream)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(200, 130), (50, 56, 49)], ids=["2d", "3d"])
def test_a_non_contiguous_input_is_copied_once(cuda, dtype, shape):
    x = torch.randn(shape, dtype=dtype, device=cuda).transpose(0, -1)
    assert not x.is_contiguous()
    want, want_n = _compressed(x.contiguous())
    _reset()
    stream, got_n = _compressed(x)
    assert codec_cuda.COPIES == dict(NONE, contiguous=1)
    assert got_n == want_n and torch.equal(stream, want)
    assert torch.equal(_bits(codec_cuda.decompress_device(stream, x.shape, dtype)), _bits(x.contiguous()))


@pytest.mark.cuda
def test_the_copy_span_lies_inside_the_api_span_before_the_launch(cuda, tmp_path):
    x = torch.randn((64, 96, 130), dtype=torch.float64, device=cuda).transpose(0, 2)
    codec_cuda.compress_device(x)  # the library built and loaded outside the trace
    torch.cuda.synchronize()
    with utils.profiler_trace(tmp_path):
        codec_cuda.compress_device(x)
        torch.cuda.synchronize()
    assert _span_names(tmp_path) == ["ndzip.compress_device", "ndzip.copy_in", "ndzip.launch"]
