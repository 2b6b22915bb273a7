"""The port's bit operations (ndzip_tpu_torch/ops/bitops.py) against the
JAX package's (ndzip_tpu/ops/bitops.py) on random uint32 and uint64 words,
exact. The 64-bit bit transpose is in test_torch_kernels.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu.ops import bitops as ref  # noqa: E402
from ndzip_tpu_torch.ops import bitops  # noqa: E402

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def random_words(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)])


def to_torch(words):
    return torch.from_numpy(words.view(np.int32))


def to_numpy(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", ["rotate_left_1", "rotate_right_1", "complement_negative"])
def test_word_op_matches_jax_package(name):
    words = random_words(4096, seed=1)
    got = to_numpy(getattr(bitops, name)(to_torch(words)))
    assert np.array_equal(got, getattr(ref, name)(words, np))


@pytest.mark.parametrize("k", [0, 1, 7, 16, 31])
def test_logical_shift_right_matches_uint32(k):
    words = random_words(4096, seed=2)
    assert np.array_equal(to_numpy(bitops.logical_shift_right(to_torch(words), k)), words >> np.uint32(k))


def test_transpose_bits_matches_jax_package():
    chunks = random_words(64 * 32 - EDGES.size, seed=3).reshape(2, 32, 32)
    got = bitops.transpose_bits(to_torch(chunks))
    assert np.array_equal(to_numpy(got), ref.transpose_bits(chunks, np))
    assert torch.equal(bitops.transpose_bits(got), to_torch(chunks))  # an involution


def test_transpose_bits_rejects_wrong_chunk_width():
    with pytest.raises(ValueError):
        bitops.transpose_bits(torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitops.transpose_bits(torch.zeros(4, 32, dtype=torch.int64))
    with pytest.raises(TypeError):
        bitops.transpose_bits(torch.zeros(4, 32, dtype=torch.int16))


EDGES64 = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1], np.uint64)


def random_words64(n, seed):
    return np.concatenate([EDGES64, np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64)])


@pytest.mark.parametrize("name", ["rotate_left_1", "rotate_right_1", "complement_negative"])
def test_word_op_64_matches_jax_package(name):
    words = random_words64(4096, seed=4)
    got = getattr(bitops, name)(torch.from_numpy(words.view(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().view(np.uint64), getattr(ref, name)(words, np))


@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 63])
def test_logical_shift_right_matches_uint64(k):
    words = random_words64(4096, seed=5)
    got = bitops.logical_shift_right(torch.from_numpy(words.view(np.int64)), k)
    assert np.array_equal(got.numpy().view(np.uint64), words >> np.uint64(k))
