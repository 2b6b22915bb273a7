"""The port's fp32 2D/3D path on CPU tensors (the plain PyTorch path) against
ndzip_tpu.golden and the JAX package's Pallas codec in interpret mode: stream
bytes, bit-exact round trips, cross-decodes both ways, and decodes that do
not depend on what lies past the stream's length."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import codec_pallas, golden  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu_torch import interop  # noqa: E402


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(codec_pallas, "INTERPRET", True)


#: tests/test_pallas.py's 2D/3D shapes, and two shapes that are all border
SHAPES = {
    "2d": (128, 192),
    "3d border": (32, 32, 33),
    "2d tiled": (128, 512),
    "2d tiled + border": (130, 513),
    "3d tiled": (16, 32, 128),
    "3d tiled + border": (17, 32, 129),
    "2d all border": (63, 100),
    "3d all border": (15, 16, 200),
}


def normal(shape, seed):
    """tests/test_pallas.py's data: normal values, a zero run, a repeated run."""
    data = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = data.reshape(-1)
    flat[:200] = 0
    flat[300:340] = flat[299]
    return data


def special_floats(shape, seed):
    data = normal(shape, seed)
    flat = data.reshape(-1)
    flat[[5, 4100, 9000]] = np.nan
    flat[[6, 4101]] = np.inf
    flat[[7, 20000]] = -np.inf
    flat[[8, 4102]] = -0.0
    flat[1000:1064] = np.float32(1e-42) * np.arange(64, dtype=np.float32)  # denormals
    return data


def random_bits(shape, seed):
    words = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return words.view(np.float32)


CASES = {label: (lambda shape=shape, seed=seed: normal(shape, seed))
         for seed, (label, shape) in enumerate(SHAPES.items())}
CASES.update({
    "2d zeros": lambda: np.zeros((128, 192), np.float32),
    "3d zeros": lambda: np.zeros((32, 32, 33), np.float32),
    "2d random bits": lambda: random_bits((130, 513), 20),
    "3d random bits": lambda: random_bits((17, 32, 129), 21),
    "2d special floats": lambda: special_floats((130, 513), 22),
    "3d special floats": lambda: special_floats((17, 32, 129), 23),
})


def same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("label", list(CASES))
def test_stream_matches_golden(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    g, g_len = golden.compress(data)
    assert int(length) == g_len
    assert interop.stream_to_numpy(stream, length).tobytes() == g.tobytes()
    assert stream.numel() == fmt.compressed_bound_u32(data.shape, 32)


@pytest.mark.parametrize("label", list(SHAPES))
def test_stream_matches_pallas_and_cross_decodes(label):
    """One Pallas compress and one Pallas decompress per shape (interpret
    mode costs seconds a call): equal bytes, and each package decodes the
    other's stream."""
    data = CASES[label]()
    ours, length = nt.compress(data, device="cpu")
    p, p_len = codec_pallas.compress(data)
    assert length == p_len and ours.tobytes() == p.tobytes()
    assert same_bits(nt.decompress(p, data.shape, device="cpu"), data)
    assert same_bits(codec_pallas.decompress(ours, data.shape, np.float32), data)


@pytest.mark.parametrize("label", list(CASES))
def test_round_trip_ignores_words_past_length(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    out = nt.decompress_device(stream[:length], data.shape)
    assert out.dtype == torch.float32 and out.shape == data.shape and same_bits(out.numpy(), data)
    junk = stream.clone()
    junk[int(length):] = -1  # 0xFFFFFFFF
    assert same_bits(nt.decompress_device(junk, data.shape).numpy(), data)


@pytest.mark.parametrize("shape", [(130, 513), (17, 32, 129)], ids=["2d", "3d"])
def test_word_views_in_and_out(shape):
    data = normal(shape, 30)
    words = torch.from_numpy(data.view(np.int32))
    stream, length = nt.compress_device(words)
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()
    for dtype in (torch.int32, np.uint32, "int32"):
        out = nt.decompress_device(stream, shape, dtype)
        assert out.dtype == torch.int32 and torch.equal(out, words)
    assert same_bits(nt.decompress(golden.compress(data)[0], shape, device="cpu"), data)
