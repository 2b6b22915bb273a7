"""The launch plans of ``codec_cuda``: what a call of one (operation, shape,
word dtype, card) needs beyond its tensors, worked out once.

On the CPU, with a stand-in for the kernels' library: a plan is built once
per key and reused, holds what ``format`` says of its shape, and a shape the
codec refuses raises every time and is never cached; every refusal that
comes before a launch raises with its message whether the plan is cold or
warm, and a host tensor builds no plan; the module imports where torch has
no ``_cuda_getCurrentRawStream``. On a card (marker ``cuda``): B1-B8 from a
cold and a warm plan give the plain version's streams byte for byte and
round-trip bit for bit, the per-call refusals hold cold and warm, a call
inside ``torch.cuda.stream(side)`` runs on ``side``, and ``plans()`` counts
one miss and N - 1 hits for N calls of one shape.
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import _build, codec_cuda, codec_torch  # noqa: E402
from ndzip_tpu_torch import format as fmt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HC = codec_torch.HC
I32, I64 = torch.int32, torch.int64


@pytest.fixture
def cold():
    codec_cuda._plan.cache_clear()
    yield
    codec_cuda._plan.cache_clear()


def _stand_ins():
    """The kernels' library as named functions that launch nothing."""
    def entry(name):
        def fn(*args):
            return 0
        fn.__name__ = name
        return fn
    return types.SimpleNamespace(**{name: entry(name) for name in _build.SIGNATURES})


@pytest.fixture
def fake_lib(monkeypatch, cold):
    """The kernels' library as stand-ins: plans are built on the CPU as on a card."""
    lib = _stand_ins()
    monkeypatch.setattr(codec_cuda._build, "load", lambda: lib)
    return lib


def _counts():
    info = codec_cuda.plans()
    return info.hits, info.misses, info.currsize


PLAN_KEYS = {
    "fp32 1d": ("encode", (4 * HC + 100,), I32, "1d", "ndzip_encode_fp32", (4, 100), "encode"),
    "fp32 2d": ("decode", (1800, 3600), I32, "nd", "ndzip_decode_fp32_nd", (2, 1, 1800, 3600), "decode_nd"),
    "fp32 3d": ("encode", (33, 16, 47), I32, "nd", "ndzip_encode_fp32_nd", (3, 33, 16, 47), "encode_nd"),
    "fp64 1d": ("decode", (2 * HC + 7,), I64, "1d", "ndzip_decode_fp64", (2, 7), "decode64"),
    "fp64 3d": ("encode", (17, 16, 129), I64, "nd", "ndzip_encode_fp64_nd", (3, 17, 16, 129), "encode64_nd"),
    "fp64 2d all border": ("decode", (63, 100), I64, "border", None, (), ""),
    "fp32 1d all border": ("encode", (100,), I32, "border", None, (), ""),
}


@pytest.mark.parametrize("label", list(PLAN_KEYS))
def test_a_plan_is_built_once_per_key_and_reused(fake_lib, label):
    op, shape, words, path, fn, args, counter = PLAN_KEYS[label]
    bits = words.itemsize * 8
    plan = codec_cuda._plan(op, shape, words, 0)
    assert _counts() == (0, 1, 1)
    for _ in range(4):
        assert codec_cuda._plan(op, shape, words, 0) is plan
    assert _counts() == (4, 1, 1)
    num_hc = fmt.num_hypercubes(shape)
    assert (plan.path, plan.shape, plan.n, plan.num_hc) == (path, shape, int(np.prod(shape)), num_hc)
    assert plan.bound == fmt.compressed_bound_u32(shape, bits)
    assert plan.header == fmt.header_u32_words(num_hc, bits)
    assert (plan.words, plan.index, plan.device) == (words, 0, torch.device("cuda", 0))
    assert (getattr(plan.fn, "__name__", None), plan.args, plan.counter) == (fn, args, counter)
    assert not counter or counter in codec_cuda.LAUNCHES
    # each other part of the key is another plan
    other_op = "decode" if op == "encode" else "encode"
    for key in ((other_op, shape, words, 0), (op, shape, words, 1),
                (op, shape, I64 if words == I32 else I32, 0)):
        assert codec_cuda._plan(*key) is not plan
    assert _counts() == (4, 4, 4)


@pytest.mark.parametrize("shape, bits, match", [
    ((4, 4, 4, 4), 32, "1-3 dimensions"),
    ((), 64, "1-3 dimensions"),
    ((64, -1), 32, "negative extent"),
    ((2**31,), 32, "int32"),
    ((1024, 1024, 1024), 64, "int32"),
], ids=["4d", "0d", "negative", "fp32 bound 2^31", "fp64 bound 2^31"])
def test_a_refused_shape_raises_every_time_and_is_not_cached(fake_lib, shape, bits, match):
    words = I32 if bits == 32 else I64
    for call in range(1, 4):
        with pytest.raises(ValueError, match=match):
            codec_cuda._plan("encode", shape, words, 0)
        assert _counts() == (0, call, 0)
    good = codec_cuda._plan("encode", (64, 64), words, 0)  # a good shape after it still works
    assert good.path == "nd" and _counts() == (0, 4, 1)


@pytest.mark.parametrize("op, shape, words, match", [
    ("encode", (100,), I32, f"the encode kernel needs at least one {HC}-word block, got 100 words"),
    ("decode", (HC - 1,), I64, f"the decode kernel needs at least one {HC}-word block, got n={HC - 1}"),
    ("encode", (63, 100), I32, r"shape \(63, 100\) has no whole block: it is all border"),
    ("decode", (15, 16, 200), I64, r"shape \(15, 16, 200\) has no whole block: it is all border"),
], ids=["encode 1d", "decode64 1d", "encode 2d", "decode64 3d"])
def test_the_wrappers_refuse_an_all_border_shape_cold_and_warm(fake_lib, op, shape, words, match):
    for _ in range(2):  # the plan cold, then warm: it is cached, the wrapper refuses it
        with pytest.raises(ValueError, match=match):
            codec_cuda._kernel_plan(op, shape, words, 0)
    assert _counts() == (1, 1, 1)
    assert codec_cuda._plan(op, shape, words, 0).path == "border"  # which the API takes


@pytest.mark.parametrize("words, shape, stream, match", [
    (I32, (2 * HC,), torch.zeros(1, dtype=I32), "cannot hold a 2-entry header"),
    (I32, (130, 513), torch.zeros(15, dtype=I32), "cannot hold a 16-entry header"),
    (I64, (3 * HC,), torch.zeros(2, dtype=I32), "cannot hold a 3-entry header"),  # the pad word too
    (I64, (3 * HC,), torch.zeros(9, dtype=I32), "whole u64 words"),
    (I64, (64, 64), torch.zeros(9, dtype=I32)[1:], "whole u64 words"),  # an odd u32 offset
], ids=["fp32 1d short", "fp32 2d short", "fp64 pad word", "fp64 odd length", "fp64 odd offset"])
def test_a_stream_is_checked_on_every_call(fake_lib, words, shape, stream, match):
    plan = codec_cuda._plan("decode", shape, words, 0)
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            codec_cuda._check_stream(plan, stream)
    codec_cuda._check_stream(plan, torch.zeros(plan.header + 2, dtype=I32))
    if words == I64:  # what decompress_device does with a stream at an odd u32 offset
        codec_cuda._check_stream(plan, torch.zeros(plan.header + 3, dtype=I32)[1:].clone())


HOST_CALLS = {
    "compress_device": (lambda: codec_cuda.compress_device(torch.zeros(64, 64)), ("encode", (64, 64), I32)),
    "compress_device fp64": (lambda: codec_cuda.compress_device(torch.zeros(2 * HC, dtype=torch.float64)),
                             ("encode", (2 * HC,), I64)),
    "decompress_device": (lambda: codec_cuda.decompress_device(torch.zeros(10, dtype=I32), (64, 64)),
                          ("decode", (64, 64), I32)),
    "decompress_device np.float64": (
        lambda: codec_cuda.decompress_device(torch.zeros(10, dtype=I32), (16, 16, 16), np.float64),
        ("decode", (16, 16, 16), I64)),
    "_encode_blocks_fp32": (lambda: codec_cuda._encode_blocks_fp32(torch.zeros(2 * HC, dtype=I32)),
                            ("encode", (2 * HC,), I32)),
    "_decode_blocks_fp32": (lambda: codec_cuda._decode_blocks_fp32(torch.zeros(10, dtype=I32), 2 * HC),
                            ("decode", (2 * HC,), I32)),
    "_encode_interior_fp32": (lambda: codec_cuda._encode_interior_fp32(torch.zeros(16, 16, 16, dtype=I32)),
                              ("encode", (16, 16, 16), I32)),
    "_decode_interior_fp32": (lambda: codec_cuda._decode_interior_fp32(torch.zeros(10, dtype=I32), (64, 64)),
                              ("decode", (64, 64), I32)),
    "_encode_blocks_fp64": (lambda: codec_cuda._encode_blocks_fp64(torch.zeros(2 * HC, dtype=I64)),
                            ("encode", (2 * HC,), I64)),
    "_decode_blocks_fp64": (lambda: codec_cuda._decode_blocks_fp64(torch.zeros(10, dtype=I32), 2 * HC),
                            ("decode", (2 * HC,), I64)),
    "_encode_interior_fp64": (lambda: codec_cuda._encode_interior_fp64(torch.zeros(64, 64, dtype=I64)),
                              ("encode", (64, 64), I64)),
    "_decode_interior_fp64": (lambda: codec_cuda._decode_interior_fp64(torch.zeros(10, dtype=I32),
                                                                       (16, 16, 16)),
                              ("decode", (16, 16, 16), I64)),
}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("label", list(HOST_CALLS))
def test_a_host_tensor_is_refused_before_any_plan(fake_lib, label, warm):
    call, key = HOST_CALLS[label]
    if warm:
        codec_cuda._plan(*key, 0)
    before, launches = _counts(), dict(codec_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA device"):
        call()
    assert _counts() == before and codec_cuda.LAUNCHES == launches


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("call, exc, match", [
    (lambda: codec_cuda.compress_device(torch.zeros(64, 64, dtype=torch.float16)), ValueError, "compress takes"),
    (lambda: codec_cuda.decompress_device(torch.zeros(10, dtype=I32), (64, 64), np.float16), ValueError,
     "decompress gives"),
    (lambda: codec_cuda.compress_device(torch.zeros(1, 1, 1, 1)), ValueError, "1-3 dimensions"),
    (lambda: codec_cuda.decompress_device(torch.zeros(10, dtype=I32), (1, 1, 1, 1)), ValueError,
     "1-3 dimensions"),
    (lambda: codec_cuda._decode_interior_fp32(torch.zeros(10, dtype=I32), (1, 1, 1, 1)), ValueError, "CUDA"),
], ids=["compress dtype", "decompress dtype", "compress 4d", "decompress 4d", "nd decode 4d"])
def test_the_dtype_and_shape_refusals_keep_their_order(fake_lib, call, exc, match, warm):
    """The API refuses a dtype or shape it cannot take before it asks for a
    CUDA tensor, as on the CPU path; a wrapper asks for the CUDA tensor first."""
    if warm:
        codec_cuda._plan("encode", (64, 64), I32, 0)
        codec_cuda._plan("decode", (64, 64), I32, 0)
    before = _counts()
    with pytest.raises(exc, match=match):
        call()
    assert _counts() == before


@pytest.mark.parametrize("label", [label for label, key in PLAN_KEYS.items() if key[3] != "border"])
def test_a_variant_launches_its_own_entry_point_with_the_plans_arguments(fake_lib, monkeypatch, label):
    """``variants.Variant`` launches, from its own library, the entry point
    that the plan names, with the plan's integer arguments where
    ``codec_cuda._encode``/``_decode`` put them."""
    from ndzip_tpu_torch import variants

    op, shape, words, _, name, args, _ = PLAN_KEYS[label]
    own = _stand_ins()
    monkeypatch.setattr(_build, "load_from", lambda csrc, names=None: own)
    launched = []
    monkeypatch.setattr(codec_cuda, "_launch", lambda fn, index, *a: launched.append((fn, index, a)))
    v = variants.Variant(Path("variant"))
    grid, stream = torch.zeros(shape, dtype=words), torch.zeros(16, dtype=I32)
    if op == "encode":
        scratch = torch.zeros(2 * (fmt.num_hypercubes(shape) + 1) + 1, dtype=I32)
        v.encode(grid, stream, scratch)
        want = (grid.data_ptr(), *args, stream.data_ptr(), scratch.data_ptr(), scratch[-1].data_ptr())
    else:
        v.decode(stream, grid)
        want = (stream.data_ptr(), stream.numel(), *args, grid.data_ptr())
    assert launched == [(getattr(own, name), 0, want)]


def test_the_module_imports_where_torch_has_no_raw_stream_call():
    code = ("import torch\n"
            "if hasattr(torch._C, '_cuda_getCurrentRawStream'):\n"
            "    del torch._C._cuda_getCurrentRawStream\n"
            "from ndzip_tpu_torch import codec_cuda, stages\n"
            "import ndzip_tpu_torch\n"
            "assert not hasattr(torch._C, '_cuda_getCurrentRawStream')\n"
            "print(codec_cuda.plans().currsize)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0"]


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _grid(shape, dtype, seed):
    """Smooth values with noise and a few special floats: blocks that compress, and some that do not."""
    rng = np.random.default_rng(seed)
    x = np.sin(np.arange(int(np.prod(shape))) * 1e-3).reshape(shape) + 1e-3 * rng.standard_normal(shape)
    x = x.astype(np.float32 if dtype == torch.float32 else np.float64)
    x.reshape(-1)[:3] = [np.nan, -0.0, np.inf]
    return torch.from_numpy(x)


#: (word dtype, shape, encoder, decoder) of each kernel pair; the ids name the kernels
KERNEL_CASES = {
    "B1 B2 fp32 1d": (torch.float32, (5 * HC + 17,), "_encode_blocks_fp32", "_decode_blocks_fp32"),
    "B3 B4 fp32 2d": (torch.float32, (130, 513), "_encode_interior_fp32", "_decode_interior_fp32"),
    "B3 B4 fp32 3d": (torch.float32, (33, 16, 47), "_encode_interior_fp32", "_decode_interior_fp32"),
    "B5 B7 fp64 1d": (torch.float64, (3 * HC + 7,), "_encode_blocks_fp64", "_decode_blocks_fp64"),
    "B6 B8 fp64 2d": (torch.float64, (130, 70), "_encode_interior_fp64", "_decode_interior_fp64"),
    "B6 B8 fp64 3d": (torch.float64, (17, 16, 129), "_encode_interior_fp64", "_decode_interior_fp64"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("via", ["wrappers", "api"])
@pytest.mark.parametrize("label", list(KERNEL_CASES))
def test_cold_and_warm_plans_match_the_plain_version(cuda, cold, label, via):
    dtype, shape, enc, dec = KERNEL_CASES[label]
    x = _grid(shape, dtype, seed=len(label)).to(cuda)
    words = x.view(I32 if dtype == torch.float32 else I64)
    ref_stream, ref_length = codec_torch.encode(words.cpu())
    L = int(ref_length)
    arg = shape[0] if len(shape) == 1 else shape
    for plan in ("cold", "warm"):
        if via == "wrappers":
            stream, length = getattr(codec_cuda, enc)(words)
            out = getattr(codec_cuda, dec)(stream[:L], arg).view(dtype)
        else:
            stream, length = codec_cuda.compress_device(x)
            out = codec_cuda.decompress_device(stream[:L], shape, dtype)
        assert (stream.dtype, stream.shape, length.dtype, length.shape) == (I32, ref_stream.shape, I32, ()), plan
        assert int(length) == L, plan
        assert stream[:L].cpu().numpy().tobytes() == ref_stream[:L].numpy().tobytes(), plan
        assert torch.equal(out.view(words.dtype), words), plan
    info = codec_cuda.plans()
    assert (info.misses, info.hits) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100,), (63, 100), (15, 16, 200)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_cold_and_warm_all_border_plans_copy(cuda, cold, dtype, shape):
    x = _grid(shape, dtype, seed=3).to(cuda)
    ref_stream, ref_length = codec_torch.encode(x.view(I32 if dtype == torch.float32 else I64).cpu())
    for _ in ("cold", "warm"):
        stream, length = codec_cuda.compress_device(x)
        assert int(length) == int(ref_length) and torch.equal(stream.cpu(), ref_stream)
        out = codec_cuda.decompress_device(stream[: int(length)], shape, dtype)
        assert out.dtype == dtype and torch.equal(out.view(torch.uint8), x.view(torch.uint8))


def _refusals(cuda):
    f32 = torch.zeros(64, 64, device=cuda)
    i32 = f32.view(I32)
    s32 = torch.zeros(8, dtype=I32, device=cuda)
    stream64, length64 = codec_cuda.compress_device(_grid((3 * HC,), torch.float64, seed=4).to(cuda))
    L = int(length64)
    storage = torch.zeros(L + 1, dtype=I32, device=cuda)
    storage[1:] = stream64[:L]
    return {
        # label: (a call that works, the refused call, exception, message)
        "wrong dtype": (lambda: codec_cuda._encode_interior_fp32(i32),
                        lambda: codec_cuda._encode_interior_fp32(f32), TypeError, "int32 words"),
        "non-contiguous input": (lambda: codec_cuda._encode_interior_fp32(i32),
                                 lambda: codec_cuda._encode_interior_fp32(i32.t()), ValueError, "contiguous"),
        "non-contiguous stream": (lambda: codec_cuda.decompress_device(s32[:4], (4,), torch.int32),
                                  lambda: codec_cuda.decompress_device(s32[::2], (4,), torch.int32),
                                  ValueError, "contiguous"),
        "4d": (lambda: codec_cuda.compress_device(f32),
               lambda: codec_cuda.compress_device(f32.reshape(1, 64, 1, 64)), ValueError, "1-3 dimensions"),
        "all border nd": (lambda: codec_cuda.compress_device(f32[:63]),
                          lambda: codec_cuda._encode_interior_fp32(i32[:63]), ValueError, "all border"),
        "short stream": (lambda: codec_cuda.decompress_device(codec_cuda.compress_device(f32)[0], (64, 64)),
                         lambda: codec_cuda._decode_interior_fp32(s32[:0], (64, 64)), ValueError, "header"),
        "short border stream": (lambda: codec_cuda.decompress_device(s32, (4,), torch.int32),
                                lambda: codec_cuda.decompress_device(s32[:3], (4,), torch.int32), ValueError,
                                "shorter than its 4 border words"),
        "fp64 stream at an odd offset": (lambda: codec_cuda._decode_blocks_fp64(stream64[:L], 3 * HC),
                                         lambda: codec_cuda._decode_blocks_fp64(storage[1:], 3 * HC),
                                         ValueError, "whole u64 words"),
    }


REFUSALS = ["wrong dtype", "non-contiguous input", "non-contiguous stream", "4d", "all border nd",
            "short stream", "short border stream", "fp64 stream at an odd offset"]


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("label", REFUSALS)
def test_the_per_call_refusals_on_the_card(cuda, cold, label, warm):
    good, bad, exc, match = _refusals(cuda)[label]
    if warm:
        good()
    launches = dict(codec_cuda.LAUNCHES)
    with pytest.raises(exc, match=match):
        bad()
    assert codec_cuda.LAUNCHES == launches


@pytest.mark.cuda
def test_an_fp64_stream_at_an_odd_offset_is_realigned_by_decompress_device(cuda, cold):
    x = _grid((3 * HC + 7,), torch.float64, seed=5).to(cuda)
    stream, length = codec_cuda.compress_device(x)
    L = int(length)
    storage = torch.zeros(L + 1, dtype=I32, device=cuda)
    storage[1:] = stream[:L]
    for _ in ("cold", "warm"):
        assert torch.equal(codec_cuda.decompress_device(storage[1:], x.shape, torch.float64).view(I64),
                           x.view(I64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [(torch.float32, (1800, 3600)), (torch.float32, (1 << 20,)),
                                          (torch.float64, (64, 64, 96))], ids=["fp32-2d", "fp32-1d", "fp64-3d"])
def test_a_call_runs_on_the_callers_stream(cuda, cold, dtype, shape):
    """With the default stream held up by a sleeping kernel, a compress and
    decompress inside ``torch.cuda.stream(side)`` finish on ``side``: their
    results read right after ``side.synchronize()``, on ``side``."""
    x = _grid(shape, dtype, seed=7).to(cuda)
    codec_cuda.compress_device(x)  # the library built and loaded before the default stream sleeps
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    torch.cuda._sleep(1 << 29)  # some 0.3 s on the default stream
    with torch.cuda.stream(side):
        stream, length = codec_cuda.compress_device(x)
        out = codec_cuda.decompress_device(stream, shape, dtype)
        side.synchronize()
        assert not torch.cuda.default_stream().query()  # the default stream still sleeps
        got = out.cpu()
    assert torch.equal(got.view(torch.uint8), x.cpu().view(torch.uint8))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [(torch.float32, (1800, 3600)), (torch.float64, (5 * HC + 3,))],
                         ids=["fp32-2d", "fp64-1d"])
def test_the_plan_counter_counts_one_miss_then_hits(cuda, cold, dtype, shape):
    x = _grid(shape, dtype, seed=9).to(cuda)
    n = 6
    for _ in range(n):
        stream, length = codec_cuda.compress_device(x)
    assert (codec_cuda.plans().misses, codec_cuda.plans().hits) == (1, n - 1)
    for _ in range(n):
        out = codec_cuda.decompress_device(stream[: int(length)], shape, dtype)
    assert (codec_cuda.plans().misses, codec_cuda.plans().hits) == (2, 2 * (n - 1))
    assert torch.equal(out.view(torch.uint8), x.view(torch.uint8))
