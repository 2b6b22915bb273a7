"""The port's fp64 path (1-3 dims) on CPU tensors (the plain PyTorch path)
against ndzip_tpu.golden and the JAX package's Pallas codec in interpret
mode, exact: stream bytes, lengths in u32 words (``compress_device``) and in
u64 words (``compress``), bit-exact round trips, decodes that do not depend
on what lies past the stream's length, cross-decodes both ways, and the word
views in and out.

On a card (marker ``cuda``; the Pallas codec is imported only by the test
that uses it, so the file runs where JAX is not installed): the public
paths of both profiles at full size, up to the cells past the L2 and past
2^31 bytes, against the plain version on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu_torch import codec_cuda, codec_torch, interop  # noqa: E402
from torch_cases import normal  # noqa: E402


@pytest.fixture
def pallas(monkeypatch):
    from ndzip_tpu import codec_pallas

    monkeypatch.setattr(codec_pallas, "INTERPRET", True)
    return codec_pallas


#: tests/test_pallas.py's SHAPES64
SHAPES64 = {
    "1d": (4096 * 8,),
    "1d border, odd block count": (4096 * 3 + 1,),
    "2d border": (128, 70),
    "3d": (16, 32, 32),
    "2d tiled": (128, 512),
    "3d tiled + axis-0 border": (17, 16, 128),
}


def special_floats(shape, seed):
    data = normal(shape, seed, np.float64)
    flat = data.reshape(-1)
    flat[[5, 4100, 9000]] = np.nan
    flat[[9, 4103]] = np.array([0x7FF0000000000001, 0xFFF80000DEADBEEF], np.uint64).view(np.float64)
    flat[[6, 4101]] = np.inf
    flat[[7, 20000]] = -np.inf
    flat[[8, 4102]] = -0.0
    flat[1000:1064] = 5e-324 * np.arange(64)  # denormals
    return data


def random_bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**64, shape, dtype=np.uint64).view(np.float64)


CASES = {label: (lambda shape=shape, seed=seed: normal(shape, seed, np.float64))
         for seed, (label, shape) in enumerate(SHAPES64.items())}
CASES.update({
    "1d zeros": lambda: np.zeros(4096 * 8),
    "3d zeros": lambda: np.zeros((17, 16, 128)),
    "1d random bits": lambda: random_bits(4096 * 3 + 1, 20),
    "2d random bits": lambda: random_bits((128, 70), 21),
    "1d special floats": lambda: special_floats(4096 * 8 + 37, 22),
    "3d special floats": lambda: special_floats((32, 32, 48), 23),
    "1d all border": lambda: np.random.default_rng(24).standard_normal(100),
    "2d all border": lambda: normal((63, 100), 25, np.float64),
})

#: the shapes whose streams the Pallas codec decodes and makes in interpret mode
CROSS = ["1d border, odd block count", "2d tiled", "3d tiled + axis-0 border"]


def same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.uint64), np.asarray(b).view(np.uint64))


@pytest.mark.parametrize("label", list(CASES))
def test_stream_matches_golden(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    g, g_len = golden.compress(data)
    assert int(length) == 2 * g_len  # u32 words
    assert interop.stream_to_numpy(stream, length).tobytes() == g.tobytes()
    assert stream.dtype == torch.int32 and stream.numel() == fmt.compressed_bound_u32(data.shape, 64)
    ours, words = nt.compress(data, device="cpu")
    assert words == g_len and ours.tobytes() == g.tobytes()  # u64 words, as golden counts them


@pytest.mark.parametrize("label", list(CASES))
def test_round_trip_ignores_words_past_length(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    out = nt.decompress_device(stream[:length], data.shape, torch.float64)
    assert out.dtype == torch.float64 and out.shape == data.shape and same_bits(out.numpy(), data)
    junk = stream.clone()
    junk[int(length):] = -1  # 0xFFFFFFFF
    assert same_bits(nt.decompress_device(junk, data.shape, np.float64).numpy(), data)


@pytest.mark.parametrize("label", CROSS)
def test_cross_decodes_with_pallas(pallas, label):
    """One Pallas compress and one Pallas decompress per shape: equal bytes
    and lengths, and each package decodes the other's stream."""
    data = CASES[label]()
    p, p_len = pallas.compress(data)
    ours, length = nt.compress(data, device="cpu")
    assert length == p_len and ours.tobytes() == p.tobytes()
    assert same_bits(nt.decompress(p, data.shape, np.float64, device="cpu"), data)
    assert same_bits(pallas.decompress(ours, data.shape, np.float64), data)


@pytest.mark.parametrize("shape", [(4096 * 3 + 1,), (130, 70), (17, 32, 129)], ids=["1d", "2d", "3d"])
def test_word_views_in_and_out(shape):
    data = normal(shape, 30, np.float64)
    words = torch.from_numpy(data.view(np.int64))
    stream, length = nt.compress_device(words)
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()
    for dtype in (torch.int64, np.uint64, "int64"):
        out = nt.decompress_device(stream, shape, dtype)
        assert out.dtype == torch.int64 and torch.equal(out, words)
    out = nt.decompress_device(stream, shape, "float64")
    assert out.dtype == torch.float64 and same_bits(out.numpy(), data)
    assert same_bits(nt.decompress(golden.compress(data)[0], shape, np.float64, device="cpu"), data)
    assert same_bits(nt.decompress(stream.numpy().view(np.uint32), shape, np.uint64, device="cpu"), data)


def test_uint64_tensor_compresses_as_its_words():
    data = random_bits(4096 * 2 + 3, 31)
    stream, length = nt.compress_device(torch.from_numpy(data.view(np.uint64)))
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()


def test_odd_length_stream_is_refused():
    data = normal(4096 * 3 + 1, 32, np.float64)
    stream, length = nt.compress_device(torch.from_numpy(data))
    with pytest.raises(ValueError, match="whole number of u64 words"):
        nt.decompress_device(stream[: int(length) - 1], data.shape, torch.float64)


def field2d(shape, dtype, seed):
    """The 2D cells' data (bench.py's CESM formula): sin(y) cos(x) + 1e-3 N(0, 1)
    on linspace(0, 11) x linspace(0, 7) at ``shape``."""
    y = np.linspace(0, 11.0, shape[0])[:, None]
    x = np.linspace(0, 7.0, shape[1])[None, :]
    return (np.sin(y) * np.cos(x) + 1e-3 * np.random.default_rng(seed).standard_normal(shape)).astype(dtype)


def line64(n, seed):
    """The fp64 1D cells' data: sin(i * 1e-4) + 1e-3 N(0, 1)."""
    return np.sin(np.arange(n, dtype=np.float64) * 1e-4) + 1e-3 * np.random.default_rng(seed).standard_normal(n)


def cube64(shape, seed):
    """The fp64 3D cells' data: sin(z) cos(y) sin(2x) + 1e-3 N(0, 1) on linspace(0, 9) along each axis."""
    z, y, x = (np.linspace(0, 9.0, e) for e in shape)
    return (np.sin(z[:, None, None]) * np.cos(y[None, :, None]) * np.sin(2 * x[None, None, :])
            + 1e-3 * np.random.default_rng(seed).standard_normal(shape))


#: the cells past the L2 of FULL_CELLS at a reduced depth, each with its block and border structure (data,
#: blocks, border elements); the fp32 2D cell stands here beside the fp64 ones, as one slice
SLICE_CELLS = {
    # 2d_1gib, fp32 16384x16384: 64x64 blocks, no border, 256-byte rows
    "2d_1gib at (128,192)": (lambda: field2d((128, 192), np.float32, 40), 6, 0),
    # 2d64_2gib, fp64 16400x16400: 64x64 blocks, a border of 16 on both axes
    "2d64_2gib at (144,208)": (lambda: field2d((2 * 64 + 16, 3 * 64 + 16), np.float64, 41), 6, 144 * 208 - 128 * 192),
    # 1d64_2gib, fp64 2^28 + 17: a border of 17
    "1d64_2gib at 3*4096+17": (lambda: line64(3 * 4096 + 17, 42), 3, 17),
    # 3d64_2gib, fp64 512x512x1036: 16^3 blocks, a border of 12 on the inner axis
    "3d64_2gib at (32,32,76)": (lambda: cube64((2 * 16, 2 * 16, 4 * 16 + 12), 43), 16, 32 * 32 * 12),
    # msg_bt fp64 33298679 (the benchmark's msg_bt.device): an odd block count, so the header's pad
    # entry, and a border of 2295
    "msg_bt at 3*4096+2295": (lambda: line64(3 * 4096 + 2295, 44), 3, 2295),
}


@pytest.mark.parametrize("label", list(SLICE_CELLS))
def test_slice_cells_at_reduced_depth_equal_golden(label):
    """The JAX package's golden stream, byte for byte, from the plain path
    (``compress_device`` on a CPU tensor) and the API's ``torch`` backend,
    and both round trips bit-exact. Tolerance: none."""
    from ndzip_tpu_torch import api

    make, num_hc, border = SLICE_CELLS[label]
    data = make()
    assert (fmt.num_hypercubes(data.shape), fmt.border_element_count(data.shape)) == (num_hc, border)
    g, g_len = golden.compress(data)
    stream, length = nt.compress_device(torch.from_numpy(data))
    assert interop.stream_to_numpy(stream, length).tobytes() == g.tobytes()
    ours, words = api.make_compressor(data.dtype, data.ndim, "torch").compress(data)
    assert words == g_len and ours.tobytes() == g.tobytes()
    out = nt.decompress_device(stream[: int(length)], data.shape, torch.from_numpy(data).dtype)
    assert out.numpy().tobytes() == data.tobytes()
    back = api.make_decompressor(data.dtype, data.ndim, "torch").decompress(g, data.shape)
    assert back.dtype == data.dtype and back.tobytes() == data.tobytes()


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def on_card(shape, dtype, dev):
    """The formulas of line64, field2d and cube64 for 1D, 2D and 3D, in
    ``dtype`` and made on the card from a ``torch.Generator`` seeded with 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if len(shape) == 1:
        d = torch.sin(torch.arange(shape[0], dtype=dtype, device=dev) * 1e-4)
    elif len(shape) == 2:
        y, x = (torch.linspace(0, span, e, dtype=dtype, device=dev) for span, e in zip((11.0, 7.0), shape))
        d = torch.sin(y)[:, None] * torch.cos(x)[None, :]
    else:
        z, y, x = (torch.linspace(0, 9.0, e, dtype=dtype, device=dev) for e in shape)
        d = torch.sin(z)[:, None, None] * torch.cos(y)[None, :, None] * torch.sin(2 * x)[None, None, :]
    return d.add_(torch.randn(shape, dtype=dtype, device=dev, generator=gen).mul_(1e-3))


#: the public paths at full size: bench.py's cells (fp32 2^24, CESM, 256^3 and 512x512x2048, fp64 2^23
#: and 512^3), the 1D formula at 2^28 + 17 fp32 and 2^27 + 17 fp64, the cells past the L2 (B3/B4
#: in 2D at 1 GiB without a border; B6/B8 in 2D, B5/B7 and B6/B8 in 3D past 2^31 bytes, with borders)
#: and msg_bt's published length (B5/B7: 8129 blocks, the header's pad entry, a border of 2295)
FULL_CELLS = {
    "fp32 2^24": ((2**24,), torch.float32),
    "fp32 2^28+17": ((2**28 + 17,), torch.float32),
    "fp32 CESM 1800x3600": ((1800, 3600), torch.float32),
    "fp32 256^3": ((256, 256, 256), torch.float32),
    "fp32 512x512x2048": ((512, 512, 2048), torch.float32),
    "2d_1gib fp32 16384x16384": ((16384, 16384), torch.float32),
    "fp64 2^23": ((2**23,), torch.float64),
    "fp64 2^27+17": ((2**27 + 17,), torch.float64),
    "fp64 512^3": ((512, 512, 512), torch.float64),
    "2d64_2gib fp64 16400x16400": ((16400, 16400), torch.float64),
    "1d64_2gib fp64 2^28+17": ((2**28 + 17,), torch.float64),
    "3d64_2gib fp64 512x512x1036": ((512, 512, 1036), torch.float64),
    "msg_bt fp64 33298679": ((33298679,), torch.float64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(FULL_CELLS))
def test_cuda_full_size_cells(cuda, label):
    """compress_device, then decompress_device on ``stream[:length]``: the
    cell launches its one encode and one decode kernel and no other codec
    kernel (counted from 0 just before), the stream is the plain version's
    on the card word for word, and the round trip is bit-exact."""
    shape, dtype = FULL_CELLS[label]
    x = on_card(shape, dtype, cuda)
    torch.cuda.synchronize()
    for k in codec_cuda.LAUNCHES:
        codec_cuda.LAUNCHES[k] = 0
    stream, length = nt.compress_device(x)
    L = int(length)
    out = nt.decompress_device(stream[:L], shape, dtype)
    torch.cuda.synchronize()
    suffix = ("64" if dtype == torch.float64 else "") + ("_nd" if len(shape) > 1 else "")
    assert {k: n for k, n in codec_cuda.LAUNCHES.items() if n} == {"encode" + suffix: 1, "decode" + suffix: 1}
    words = codec_torch.as_words(x)
    assert torch.equal(codec_torch.as_words(out), words)
    del out
    plain, plain_length = codec_torch.encode(words)
    assert int(plain_length) == L and torch.equal(plain[:L], stream[:L])
