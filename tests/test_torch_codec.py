"""The port's fp32 1D slice on CPU tensors (the plain PyTorch path) against
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
from torch_cases import normal  # noqa: E402


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(codec_pallas, "INTERPRET", True)


def special_floats(n, seed):
    data = normal(n, seed)
    data[[5, 4100, 9000]] = np.nan
    data[[6, 4101]] = np.inf
    data[[7, 20000]] = -np.inf
    data[[8, 4102]] = -0.0
    data[1000:1064] = np.float32(1e-42) * np.arange(64, dtype=np.float32)  # denormals
    return data


def random_bits(n, seed):
    words = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return words.view(np.float32)


CASES = {
    "1d": lambda: normal(4096 * 8, 1),
    "1d border": lambda: normal(4096 * 8 + 100, 2),
    "all zero": lambda: np.zeros(4096 * 8, np.float32),
    "n=100 all border": lambda: np.random.default_rng(3).standard_normal(100).astype(np.float32),
    "n=4096 one block": lambda: normal(4096, 4),
    "incompressible": lambda: random_bits(4096 * 8, 5),
    "special floats": lambda: special_floats(4096 * 8, 6),
}


def same_bits(a, b):
    return np.array_equal(np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("label", list(CASES))
def test_stream_matches_golden_and_pallas(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    ours = interop.stream_to_numpy(stream, length)
    g, g_len = golden.compress(data)
    p, p_len = codec_pallas.compress(data)
    assert int(length) == g_len == p_len
    assert ours.tobytes() == g.tobytes() == p.tobytes()
    assert stream.numel() == fmt.compressed_bound_u32(data.shape, 32)


@pytest.mark.parametrize("label", list(CASES))
def test_round_trip_ignores_words_past_length(label):
    data = CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data))
    out = nt.decompress_device(stream[:length], data.shape)
    assert out.dtype == torch.float32 and same_bits(out.numpy(), data)
    junk = stream.clone()
    junk[int(length):] = -1  # 0xFFFFFFFF
    assert same_bits(nt.decompress_device(junk, data.shape).numpy(), data)


@pytest.mark.parametrize("label", list(CASES))
def test_cross_decode_with_pallas(label):
    data = CASES[label]()
    p, _ = codec_pallas.compress(data)
    assert same_bits(nt.decompress(p, data.shape, device="cpu"), data)
    ours, _ = nt.compress(data, device="cpu")
    assert same_bits(codec_pallas.decompress(ours, data.shape, np.float32), data)


def test_word_views_in_and_out():
    data = normal(4096 * 3 + 7, 7)
    words = torch.from_numpy(data.view(np.int32))
    stream, length = nt.compress_device(words)
    assert interop.stream_to_numpy(stream, length).tobytes() == golden.compress(data)[0].tobytes()
    for dtype in (torch.int32, np.uint32, "int32"):
        out = nt.decompress_device(stream, data.shape, dtype)
        assert out.dtype == torch.int32 and torch.equal(out, words)


def test_empty_input():
    stream, length = nt.compress_device(torch.zeros(0))
    assert int(length) == 0 and stream.numel() == 0
    assert nt.decompress_device(stream, (0,)).numel() == 0
