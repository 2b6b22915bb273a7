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
1024 border CTAs are more than the card holds at once, and thin borders;
and on 3D grids through both of the encoder's block loads, each counted in
``codec_cuda.LOADS3D``: one tensor-map box a block where rows start 16-byte
aligned, the row walk from a view 4 bytes off 16; and through both of the
decoder's block stores, each counted in ``codec_cuda.STORES3D``: one
tensor-map box a block where the minor extent is a multiple of 4 words (also
from a stream that starts 1-3 words past 16 bytes), the row walk where it is
not, each decoding ``ndzip_tpu.golden``'s stream. On the CPU, a numpy model
of the 3D box path's fused pass, lane by lane, is held to
``golden.block_transform``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch import codec_cuda, interop  # noqa: E402
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


def box_pass(blocks: np.ndarray) -> np.ndarray:
    """The 3D encoder's fused pass over a block as its tensor-map box leaves
    it (csrc/encode_fp32_nd.cu's difference_box), lane by lane in numpy:
    thread t walks the z line at (y, x) = (t // 16, t % 16); each word is
    rotated left by one, less the rotated word 16 before it in the box (y;
    none for t < 16), then less what the lane before holds
    (``__shfl_up_sync`` by 1: lane 0 keeps its own) where x > 0, then less
    the value before it on the line (z), then complement-negative.
    ``blocks``: (nb, 4096) uint32 in a block's row-major order."""
    box = blocks.reshape(-1, 16, 256).astype(np.uint32)  # [block, z, t]
    t = np.arange(256)
    rot = (box << np.uint32(1)) | (box >> np.uint32(31))
    up = np.where(t >= 16, np.roll(rot, 16, axis=2), np.uint32(0))
    dy = rot - up
    lane = t % 32
    shuffled = np.where(lane > 0, np.roll(dy, 1, axis=2), dy)
    dxy = dy - np.where(t % 16 > 0, shuffled, np.uint32(0))
    before = np.concatenate([np.zeros_like(dxy[:, :1]), dxy[:, :-1]], axis=1)
    d = dxy - before
    return np.where(d >> np.uint32(31) == 1, d ^ np.uint32(0x7FFFFFFF), d).reshape(-1, fmt.HC_SIZE)


def _blocks_of(data):
    return data.view(np.uint32).reshape(-1, fmt.HC_SIZE)


BOX_PASS_CASES = {
    "normal values": lambda: _blocks_of(normal((8, 16, 16, 16), 70)),
    "random bits": lambda: _blocks_of(random_bits((8, 4096), 71)),
    "special floats": lambda: _blocks_of(special_floats((8, 4096), 72)),
    "all-equal blocks": lambda: np.repeat(np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x3FC00000], np.uint32),
                                          fmt.HC_SIZE).reshape(-1, fmt.HC_SIZE),
}


@pytest.mark.parametrize("label", list(BOX_PASS_CASES))
def test_the_box_pass_model_gives_the_forward_transform(label):
    blocks = BOX_PASS_CASES[label]()
    with np.errstate(over="ignore"):
        assert np.array_equal(box_pass(blocks), golden.block_transform(blocks, 3))


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


#: 3D grids and the load the encoder takes for their blocks (``codec_cuda.LOADS3D``): where rows
#: start 16-byte aligned, one tensor-map box a block (whole blocks alone, bordered on every axis,
#: 1024 border CTAs, 512^3 as the magrecon cell holds it, special floats, random bits); the same
#: data from a view whose base lies 4 bytes off 16, the row walk
LOAD_CASES = {
    "box (16,16,16)": (lambda: normal((16, 16, 16), 60), 0, "tensor_map"),
    "box (16,32,128)": (lambda: normal((16, 32, 128), 61), 0, "tensor_map"),
    "box (48,48,64)": (lambda: normal((48, 48, 64), 62), 0, "tensor_map"),
    "box 512^3": (lambda: normal((512, 512, 512), 63), 0, "tensor_map"),
    "box bordered on every axis (33,50,68)": (lambda: normal((33, 50, 68), 64), 0, "tensor_map"),
    "box 1024 border CTAs (20,1024,1024)": (lambda: normal((20, 1024, 1024), 65), 0, "tensor_map"),
    "box special floats (32,48,64)": (lambda: special_floats((32, 48, 64), 66), 0, "tensor_map"),
    "box random bits (32,32,48)": (lambda: random_bits((32, 32, 48), 67), 0, "tensor_map"),
    "rows, base 4 bytes off 16 (16,32,128)": (lambda: normal((16, 32, 128), 61), 1, "rows"),
    "rows, base 4 bytes off 16 (33,50,68)": (lambda: normal((33, 50, 68), 64), 1, "rows"),
    "rows, base 4 bytes off 16, special floats (32,48,64)": (lambda: special_floats((32, 48, 64), 66), 1,
                                                             "rows"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(LOAD_CASES))
def test_box_and_row_loads_on_the_card_match_golden(cuda, label):
    make, offset, load = LOAD_CASES[label]
    data = make()
    storage = torch.empty(data.size + offset, dtype=torch.float32, device=cuda)
    x = storage[offset:].view(data.shape)
    x.copy_(torch.from_numpy(data))
    assert x.data_ptr() % 16 == 4 * offset
    for key in codec_cuda.LOADS3D:
        codec_cuda.LOADS3D[key] = 0
    stream, length = nt.compress_device(x)
    assert codec_cuda.LOADS3D == dict({"tensor_map": 0, "rows": 0}, **{load: 1})
    g, g_len = golden.compress(data)
    assert int(length) == g_len
    assert interop.stream_to_numpy(stream.cpu(), length.cpu()).tobytes() == g.tobytes()
    out = nt.decompress_device(stream[:length], data.shape)
    assert same_bits(out.cpu().numpy(), data)


#: 3D grids and the store the decoder takes for their blocks (``codec_cuda.STORES3D``), with the
#: word offset of the stream in its buffer: where the minor extent is a multiple of 4 words (the
#: output is a fresh, aligned tensor), one tensor-map box a block (a whole block alone, whole
#: blocks, 512^3 as the magrecon cell holds it, bordered on every axis, 1024 border CTAs, special
#: floats, random bits, and a stream that starts 1-3 words past 16 bytes); else the row walk
STORE_CASES = {
    "box (16,16,16)": (lambda: normal((16, 16, 16), 70), 0, "tensor_map"),
    "box (48,48,64)": (lambda: normal((48, 48, 64), 71), 0, "tensor_map"),
    "box 512^3": (lambda: normal((512, 512, 512), 72), 0, "tensor_map"),
    "box bordered on every axis (33,50,68)": (lambda: normal((33, 50, 68), 73), 0, "tensor_map"),
    "box 1024 border CTAs (20,1024,1024)": (lambda: normal((20, 1024, 1024), 74), 0, "tensor_map"),
    "box special floats (32,48,64)": (lambda: special_floats((32, 48, 64), 75), 0, "tensor_map"),
    "box random bits (32,32,48)": (lambda: random_bits((32, 32, 48), 76), 0, "tensor_map"),
    "box, stream at word offset 1 (48,48,64)": (lambda: normal((48, 48, 64), 77), 1, "tensor_map"),
    "box, stream at word offset 2 (33,50,68)": (lambda: normal((33, 50, 68), 78), 2, "tensor_map"),
    "box, stream at word offset 3 (32,48,64)": (lambda: special_floats((32, 48, 64), 79), 3, "tensor_map"),
    "rows, odd minor extent (17,32,129)": (lambda: normal((17, 32, 129), 80), 0, "rows"),
    "rows, minor extent 2 mod 4 (16,16,18)": (lambda: normal((16, 16, 18), 81), 0, "rows"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(STORE_CASES))
def test_box_and_row_stores_on_the_card_match_golden(cuda, label):
    make, offset, store = STORE_CASES[label]
    data = make()
    g, g_len = golden.compress(data)
    stream, length = nt.compress_device(torch.from_numpy(data).to(cuda))
    assert int(length) == g_len
    assert interop.stream_to_numpy(stream.cpu(), length.cpu()).tobytes() == g.tobytes()
    buffer = torch.empty(g.size + offset, dtype=torch.int32, device=cuda)
    sliced = buffer[offset:]
    sliced.copy_(torch.from_numpy(g.view(np.int32)))  # golden's stream, not the card's
    assert sliced.data_ptr() % 16 == 4 * offset
    for key in codec_cuda.STORES3D:
        codec_cuda.STORES3D[key] = 0
    out = nt.decompress_device(sliced, data.shape)
    assert codec_cuda.STORES3D == dict({"tensor_map": 0, "rows": 0}, **{store: 1})
    assert out.data_ptr() % 16 == 0
    assert same_bits(out.cpu().numpy(), data)
