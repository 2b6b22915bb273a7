"""Seeded randomized search on the port: random shapes (whole blocks plus
borders, tiny and degenerate extents) x random sparsity patterns, both dtypes,
1-3 dims, with tests/test_fuzz.py's generators and seeds (copied: that file
sets up the Pallas codec on import). On the CPU the plain versions of
``codec_torch`` against the port's ``golden``, stream and round trip, exact.
On a card (marker ``cuda``, skipped elsewhere) the same cases on the CUDA
kernels, also from ``golden``'s stream at word offsets 0-3 of its storage:
``NDZIP_TPU_TESTS_TPU=1 python -m pytest tests/test_torch_fuzz.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu_torch import codec_cuda, golden, interop  # noqa: E402


def _random_shape(rng, dims):
    if dims == 1:
        n = int(rng.integers(1, 5)) * 4096 + int(rng.integers(0, 300))
        return (n,)
    if dims == 2:
        return (int(rng.integers(1, 4)) * 64 + int(rng.integers(0, 70)),
                int(rng.integers(1, 9)) * 64 + int(rng.integers(0, 70)))
    return tuple(int(rng.integers(1, 4)) * 16 + int(rng.integers(0, 18))
                 for _ in range(3))


def _random_data(rng, shape, dtype):
    n = int(np.prod(shape))
    style = rng.integers(0, 4)
    if style == 0:      # smooth (high compression)
        data = np.sin(np.arange(n) * 1e-3).astype(dtype)
    elif style == 1:    # random (incompressible)
        data = rng.standard_normal(n).astype(dtype)
    elif style == 2:    # mostly zero with random spikes
        data = np.zeros(n, dtype)
        idx = rng.integers(0, n, max(1, n // 50))
        data[idx] = rng.standard_normal(idx.size)
    else:               # constant runs
        data = np.repeat(rng.standard_normal(max(1, n // 97 + 1)),
                         97)[:n].astype(dtype)
    return data.reshape(shape)


CASES = [(d, dt, s) for s in range(2) for d in (1, 2, 3)
         for dt in (np.float32, np.float64)]
#: more seeds of the same generators: cheap on the plain path, and every style
#: and border pattern comes up in each profile
MORE_CASES = [(d, dt, s) for s in range(2, 8) for d in (1, 2, 3)
              for dt in (np.float32, np.float64)]
#: tiny and degenerate extents, which the generators above never draw
TINY_SHAPES = [(1,), (4095,), (4096,), (1, 1), (63, 64), (64, 63), (64, 64), (1, 200),
               (15, 16, 16), (16, 16, 16), (1, 1, 1), (16, 1, 40), (17, 16, 15)]


def _case(dims, dtype, seed):
    rng = np.random.default_rng(1000 * seed + dims)
    shape = _random_shape(rng, dims)
    return shape, _random_data(rng, shape, dtype)


def _hold_to_golden(data, device, offsets=(0,)):
    """compress_device and decompress_device on ``device`` against golden:
    the stream byte for byte, the round trip bit for bit, and the decode of
    golden's own stream, as a view at each of ``offsets`` of its storage."""
    shape, dtype = data.shape, data.dtype
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    g, gl = golden.compress(data)
    x = torch.from_numpy(data).to(device)
    stream, length = nt.compress_device(x)
    L = int(length)
    assert L == gl * (data.itemsize // 4), f"{shape} {dtype}: length {L} != {gl}"
    assert interop.stream_to_numpy(stream, L).tobytes() == g.tobytes(), f"{shape} {dtype}: stream mismatch"
    out = nt.decompress_device(stream[:L], shape, dtype)
    assert np.array_equal(out.cpu().numpy().view(wdt), data.view(wdt)), f"{shape} {dtype}"
    for offset in offsets:
        storage = torch.full((offset + g.size,), -1, dtype=torch.int32, device=device)
        storage[offset:] = torch.from_numpy(g.view(np.int32)).to(device)
        out = nt.decompress_device(storage[offset:], shape, dtype)
        assert np.array_equal(out.cpu().numpy().view(wdt), data.view(wdt)), f"{shape} {dtype} at offset {offset}"
    assert np.array_equal(golden.decompress(g, shape, dtype).view(wdt), data.view(wdt))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dims,dtype,seed", CASES + MORE_CASES)
def test_fuzz_round_trip_bit_exact(dims, dtype, seed):
    _, data = _case(dims, dtype, seed)
    _hold_to_golden(data, "cpu")


@pytest.mark.parametrize("shape", TINY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_fuzz_tiny_shapes_bit_exact(dtype, shape):
    rng = np.random.default_rng(len(shape) + sum(shape))
    _hold_to_golden(_random_data(rng, shape, dtype), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype,seed", CASES + MORE_CASES)
def test_cuda_fuzz_round_trip_bit_exact(cuda, dims, dtype, seed):
    """The same cases on the kernels; the count of launches shows that a grid
    with a whole block went through its encode and decode kernels."""
    shape, data = _case(dims, dtype, seed)
    before = dict(codec_cuda.LAUNCHES)
    # an fp64 stream holds whole u64 words: odd offsets are realigned by a copy, and so are taken too
    _hold_to_golden(data, cuda, offsets=(0, 1, 2, 3))
    suffix = ("64" if dtype == np.float64 else "") + ("_nd" if dims > 1 else "")
    assert codec_cuda.LAUNCHES["encode" + suffix] == before["encode" + suffix] + 1
    assert codec_cuda.LAUNCHES["decode" + suffix] == before["decode" + suffix] + 5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TINY_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_cuda_fuzz_tiny_shapes_bit_exact(cuda, dtype, shape):
    rng = np.random.default_rng(len(shape) + sum(shape))
    _hold_to_golden(_random_data(rng, shape, dtype), cuda, offsets=(0, 1, 2, 3))
