"""The port's fp32 2D/3D path on CPU tensors (the plain PyTorch path) against
ndzip_tpu.golden and the JAX package's Pallas codec in interpret mode: stream
bytes, bit-exact round trips, cross-decodes both ways, and decodes that do
not depend on what lies past the stream's length.

On a card (marker ``cuda``; the Pallas codec is imported only by the test
that uses it, so the file runs where JAX is not installed, and
``ndzip_tpu.golden`` needs only numpy): the encoder's border CTAs, which
stage their share before they wait for the last block's sum, give
``ndzip_tpu.golden``'s stream byte for byte, and the decoder gives every
bit back, on bordered grids: CESM's 1800x3600 under several seeds and as a
constant field (the border's first stream word at different offsets in a
128-byte line), 3D grids bordered on every axis, (20, 1024, 1024), whose
1024 border CTAs are more than the card holds at once, and thin borders."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch import interop  # noqa: E402
from torch_cases import normal  # noqa: E402


@pytest.fixture
def pallas(monkeypatch):
    from ndzip_tpu import codec_pallas

    monkeypatch.setattr(codec_pallas, "INTERPRET", True)
    return codec_pallas


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
#: thin borders: planes of 16 or 128 border words, rows with no word past the blocks, one row
#: past them, no plane border at all (only the last planes), a 2D right or bottom strip alone;
#: and a 3D grid bordered on every axis whose 4096-word border shares cross planes
THIN_BORDERS = {
    "3d planes of 16 border words": (17, 16, 17),
    "3d rows without a word past the blocks": (20, 50, 64),
    "3d one row past the blocks": (18, 17, 16),
    "3d only the last planes": (33, 16, 16),
    "2d right strip alone": (64, 65),
    "2d bottom strip alone": (65, 4096),
    "3d every axis": (33, 50, 70),
}
CASES.update({label: (lambda shape=shape, seed=seed: normal(shape, seed))
              for seed, (label, shape) in enumerate(THIN_BORDERS.items(), start=24)})
CASES.update({
    "3d planes of 16 border words, random bits": lambda: random_bits((17, 16, 17), 31),
    "2d right strip alone, random bits": lambda: random_bits((64, 65), 32),
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
def test_stream_matches_pallas_and_cross_decodes(pallas, label):
    """One Pallas compress and one Pallas decompress per shape (interpret
    mode costs seconds a call): equal bytes, and each package decodes the
    other's stream."""
    data = CASES[label]()
    ours, length = nt.compress(data, device="cpu")
    p, p_len = pallas.compress(data)
    assert length == p_len and ours.tobytes() == p.tobytes()
    assert same_bits(nt.decompress(p, data.shape, device="cpu"), data)
    assert same_bits(pallas.decompress(ours, data.shape, np.float32), data)


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


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: bordered grids for the encoder's border CTAs: CESM's 1800x3600 (15 border CTAs, the last of
#: 128 words) under four seeds, as a constant field and with special floats, so that the border
#: starts at different words of a 128-byte line; 3D grids bordered on every axis (CTA shares that
#: cross planes); (20, 1024, 1024), whose 1024 border CTAs are more than an H100 holds at once,
#: so every border CTA's wait must still end; and the thin borders of THIN_BORDERS
BORDER_CASES = {
    "cesm seed 40": lambda: normal((1800, 3600), 40),
    "cesm seed 41": lambda: normal((1800, 3600), 41),
    "cesm seed 42": lambda: normal((1800, 3600), 42),
    "cesm seed 43": lambda: normal((1800, 3600), 43),
    "cesm constant": lambda: np.full((1800, 3600), 1.5, np.float32),
    "cesm special floats": lambda: special_floats((1800, 3600), 44),
    "3d every axis 17x32x129": lambda: normal((17, 32, 129), 46),
    "3d odd minor extent 37x150x1001": lambda: normal((37, 150, 1001), 47),
    "3d 1024 border CTAs 20x1024x1024": lambda: normal((20, 1024, 1024), 48),
    "2d tiled + border": lambda: normal((130, 513), 49),
}
BORDER_CASES.update({label: (lambda shape=shape, seed=seed: normal(shape, seed))
                     for seed, (label, shape) in enumerate(THIN_BORDERS.items(), start=50)})


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(BORDER_CASES))
def test_border_ctas_on_the_card_match_golden(cuda, label):
    data = BORDER_CASES[label]()
    stream, length = nt.compress_device(torch.from_numpy(data).to(cuda))
    g, g_len = golden.compress(data)
    assert int(length) == g_len
    assert interop.stream_to_numpy(stream.cpu(), length.cpu()).tobytes() == g.tobytes()
    out = nt.decompress_device(stream[:length], data.shape)
    assert same_bits(out.cpu().numpy(), data)
