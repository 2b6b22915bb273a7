"""The port's fp64 path (1-3 dims) on CPU tensors (the plain PyTorch path)
against ndzip_tpu.golden and the JAX package's Pallas codec in interpret
mode, exact: stream bytes, lengths in u32 words (``compress_device``) and in
u64 words (``compress``), bit-exact round trips, decodes that do not depend
on what lies past the stream's length, cross-decodes both ways, and the word
views in and out."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu_torch import interop  # noqa: E402


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


def normal(shape, seed):
    """tests/test_pallas.py's data: normal values, a zero run, a repeated run."""
    data = np.random.default_rng(seed).standard_normal(shape)
    flat = data.reshape(-1)
    flat[:200] = 0
    flat[300:340] = flat[299]
    return data


def special_floats(shape, seed):
    data = normal(shape, seed)
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


CASES = {label: (lambda shape=shape, seed=seed: normal(shape, seed))
         for seed, (label, shape) in enumerate(SHAPES64.items())}
CASES.update({
    "1d zeros": lambda: np.zeros(4096 * 8),
    "3d zeros": lambda: np.zeros((17, 16, 128)),
    "1d random bits": lambda: random_bits(4096 * 3 + 1, 20),
    "2d random bits": lambda: random_bits((128, 70), 21),
    "1d special floats": lambda: special_floats(4096 * 8 + 37, 22),
    "3d special floats": lambda: special_floats((32, 32, 48), 23),
    "1d all border": lambda: np.random.default_rng(24).standard_normal(100),
    "2d all border": lambda: normal((63, 100), 25),
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
    data = normal(shape, 30)
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
    data = normal(4096 * 3 + 1, 32)
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


#: chip_smoke.py's cells past the L2 at a reduced depth, each with its block and border structure (data,
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
