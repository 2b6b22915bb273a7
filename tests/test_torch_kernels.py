"""The eight kernels of the port and the plain versions they are held to.

On the CPU: the plain PyTorch versions (codec_torch.encode_blocks_ref,
decode_blocks_ref, block_transform, the gather and border functions, the
bit transpose) against ``golden``, ``format.border_slices``, the JAX
package's bit ops and its Pallas kernels in interpret mode, exact bits:
B1 (_encode_blocks_fp32) and B2 (_decode_blocks_fp32) for 1D and the gather
route of 2D, B3 (_encode_interior_fp32) and B4 (_decode_interior_fp32) for
tiled 2D/3D grids, and their fp64 counterparts B5-B8 on int64 words, whose
JAX versions take (lo, hi) u32 planes (``interop.planes_from_words``); and
the 1D encoder's one-pass transform of its bulk-copied block, lane by lane
in numpy, against ``golden.block_transform``. On a
card (marker ``cuda``, skipped elsewhere): the CUDA kernels against the
plain versions and against ``golden`` on the cases of ``torch_cases``,
exact: the kernel's stream is golden's byte for byte, and the decode kernel
gives back the input from golden's stream; the 1D encoder also on inputs
that stress its look-back and its L2 prefetch, many times and on two CUDA
streams, and on a caller's view 4 bytes off alignment, and the 1D
decoder on stream views at any word offset, without slack and truncated; the
2D/3D pair on the same, and on bordered grids whose border needs more CTAs
than the card holds at once or whose rows are not 16-byte aligned; the fp64
decoders on stream views at u64 offsets 0-3 without slack, at odd u32
offsets through decompress_device, and truncated at even u32 counts.
Run those on the card
with ``NDZIP_TPU_TESTS_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda``
(the variable keeps tests/conftest.py from setting up JAX, which the port's
GPU machines need not have).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu.ops import bitops as ref_bitops  # noqa: E402
from ndzip_tpu.ops import u64pair  # noqa: E402
from ndzip_tpu_torch import _build, codec_cuda, codec_torch, interop  # noqa: E402
from ndzip_tpu_torch.ops import bitops  # noqa: E402
from torch_cases import (fp64_kernel_cases, kernel_cases, nd_border_shapes, nd_kernel_cases, normal,  # noqa: E402
                         special_floats)

HC = codec_torch.HC


@pytest.fixture
def pallas(monkeypatch):
    """The JAX package's Pallas codec in interpret mode. JAX is imported here
    and not at the top, so the card's tests run where JAX is not installed."""
    from ndzip_tpu import codec_pallas

    monkeypatch.setattr(codec_pallas, "INTERPRET", True)
    return codec_pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


#: the fourteen codec kernels, each by a part of its mangled name that no other kernel's holds, with
#: the C function (and its argument) that gives the CTAs of it that one SM holds
PTXAS_KERNELS = {
    "5ndzip20encode_blocks_nd_boxE": ("ndzip_encode_fp32_nd_box_ctas_per_sm", ()),
    "5ndzip20decode_blocks_nd_boxE": ("ndzip_decode_fp32_nd_box_ctas_per_sm", ()),
    "5ndzip13encode_blocksE": ("ndzip_encode_fp32_ctas_per_sm", ()),
    "5ndzip13decode_blocksE": ("ndzip_decode_fp32_ctas_per_sm", ()),
    "5ndzip16encode_blocks_ndILi2E": ("ndzip_encode_fp32_nd_ctas_per_sm", (2,)),
    "5ndzip16encode_blocks_ndILi3E": ("ndzip_encode_fp32_nd_ctas_per_sm", (3,)),
    "5ndzip16decode_blocks_ndILi2E": ("ndzip_decode_fp32_nd_ctas_per_sm", (2,)),
    "5ndzip16decode_blocks_ndILi3E": ("ndzip_decode_fp32_nd_ctas_per_sm", (3,)),
    "5ndzip15encode_blocks64E": ("ndzip_encode_fp64_ctas_per_sm", ()),
    "5ndzip18encode_blocks64_ndILi2E": ("ndzip_encode_fp64_nd_ctas_per_sm", (2,)),
    "5ndzip18encode_blocks64_ndILi3E": ("ndzip_encode_fp64_nd_ctas_per_sm", (3,)),
    "5ndzip15decode_blocks64E": ("ndzip_decode_fp64_ctas_per_sm", ()),
    "5ndzip18decode_blocks64_ndILi2E": ("ndzip_decode_fp64_nd_ctas_per_sm", (2,)),
    "5ndzip18decode_blocks64_ndILi3E": ("ndzip_decode_fp64_nd_ctas_per_sm", (3,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(PTXAS_KERNELS))
def test_cuda_ptxas_reports_each_kernel_once(cuda, kernel):
    """ptxas -v reports each codec kernel once, at least one CTA of it fits
    an SM, the 3D encoder's and decoder's box paths hold six CTAs an SM as
    their row walks do, the 1D fp32 encoder holds six CTAs an SM beside its
    bulk copy's barrier, the 1D fp32 encoder and the 3D decoder's box path
    spill nothing under the bound that keeps them there, and the fp64
    decoders, whose register bound is set for their shared memory (four
    CTAs an SM), spill nothing under it."""
    ctas, args = PTXAS_KERNELS[kernel]
    lines = _build.ptxas_lines(kernel)
    assert len(lines) == 1, lines
    assert getattr(_build.load(), ctas)(*args) >= 1
    if "encode_blocks_nd_box" in kernel:  # the box lands in a buffer the row walk has too: six CTAs, as there
        assert getattr(_build.load(), ctas)(*args) == _build.load().ndzip_encode_fp32_nd_ctas_per_sm(3) == 6
    if "decode_blocks_nd_box" in kernel:  # the box goes out of the run buffer: six CTAs, as the row walk
        assert getattr(_build.load(), ctas)(*args) == _build.load().ndzip_decode_fp32_nd_ctas_per_sm(3) == 6
    if kernel == "5ndzip13encode_blocksE":  # the block lands in the run buffer: six CTAs, as before the bulk copy
        assert getattr(_build.load(), ctas)(*args) == 6
    if "decode_blocks64" in kernel or "decode_blocks_nd_box" in kernel or kernel == "5ndzip13encode_blocksE":
        assert re.findall(r"(\d+) bytes spill (?:stores|loads)", lines[0]) == ["0", "0"], lines[0]


def _sass(pad: int, op: str = "IADD3 R4, P0, R2, R6, RZ") -> str:
    """A ``cuobjdump -sass`` listing of two kernels, its columns padded by ``pad`` blanks."""
    gap = " " * pad
    return (f"\tcode for sm_90a\n\t\tFunction : _ZN5ndzip1aEv\n\t.headerflags @\"EF_CUDA_SM90\"\n"
            f"        /*0000*/                   LDC R1, c[0x0][0x28] ;{gap}   /* 0x00000a00ff017b82 */\n"
            f"                                                      {gap}   /* 0x000e620000000800 */\n"
            f"        /*0010*/                   {op} ;{gap}   /* 0x0000000602047210 */\n"
            f"\t\t..........\n\n\t\tFunction : _ZN5ndzip1bEv\n"
            f"        /*0000*/                   EXIT ;{gap}   /* 0x000000000000794d */\n")


def test_sass_is_compared_without_the_padding_of_its_columns():
    """``variants sass`` holds a kernel's instructions and encodings, by its
    mangled name; cuobjdump pads a file's columns to its widest instruction,
    which a kernel added beside the others widens."""
    from ndzip_tpu_torch import variants

    narrow = variants.sass_by_kernel(_sass(0))
    assert sorted(narrow) == ["_ZN5ndzip1aEv", "_ZN5ndzip1bEv"]
    assert narrow["_ZN5ndzip1aEv"].splitlines()[0] == "/*0000*/ LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */"
    assert len(narrow["_ZN5ndzip1aEv"].splitlines()) == 3 and narrow["_ZN5ndzip1bEv"].count("\n") == 0
    assert variants.sass_by_kernel(_sass(7)) == narrow
    assert variants.sass_by_kernel(_sass(0, "IADD3 R4, P0, R2, R7, RZ"))["_ZN5ndzip1aEv"] != narrow["_ZN5ndzip1aEv"]


@pytest.mark.parametrize("nb", [8, 13])
def test_encode_blocks_ref_matches_pallas(pallas, nb):
    blocks = normal((nb, HC), nb).view(np.uint32)
    header, body, lengths = codec_torch.encode_blocks_ref(torch.from_numpy(blocks.view(np.int32)))

    G = pallas.G_ENC
    padded = np.zeros((-(-nb // G) * G, HC), np.uint32)
    padded[:nb] = blocks
    body2d, hdr2d = pallas._encode_blocks_fp32(padded, 1, nb)
    jax_header = np.asarray(hdr2d)[:, :G].reshape(-1)[:nb]
    body_total = int(jax_header[-1])
    jax_body = np.asarray(body2d).reshape(-1)[nb: nb + body_total]

    assert np.array_equal(header.numpy().view(np.uint32), jax_header)
    assert np.array_equal(body.numpy().view(np.uint32), jax_body)
    assert np.array_equal(np.cumsum(lengths.numpy()), jax_header)


@pytest.mark.parametrize("nb", [8, 13])
def test_decode_blocks_ref_matches_pallas(pallas, nb):
    blocks = normal((nb, HC), 100 + nb).view(np.uint32)
    stream, _ = golden.compress(blocks.reshape(-1).view(np.float32))
    ours = codec_torch.decode_blocks_ref(torch.from_numpy(stream.view(np.int32)), nb)

    # starts as _decode_fp32_device builds them: header offsets after num_hc,
    # padded to a multiple of G_DEC with the last block's start
    offsets = stream[:nb].astype(np.int32)
    starts = nb + np.concatenate([[0], offsets[:-1]]).astype(np.int32)
    nb_pad = -(-nb // pallas.G_DEC) * pallas.G_DEC
    starts = np.concatenate([starts, np.full(nb_pad - nb, starts[-1], np.int32)])
    lanes = pallas.LANES
    rows = -(-(stream.size + pallas.WIN_ROWS * lanes) // lanes)
    padded = np.zeros(rows * lanes, np.uint32)
    padded[: stream.size] = stream
    theirs = pallas._decode_blocks_fp32(
        padded.reshape(rows, lanes), starts, 1, nb)

    assert np.array_equal(ours.numpy().view(np.uint32), np.asarray(theirs)[:nb])
    assert np.array_equal(ours.numpy().view(np.uint32), blocks)


@pytest.mark.parametrize("label", list(kernel_cases()))
def test_plain_codec_is_golden_on_the_kernel_cases(label):
    """The plain 1D path that the card's B1/B2 are held to below: its stream
    is golden's byte for byte, and its decode of golden's stream gives back
    the input."""
    data = kernel_cases()[label]
    w = torch.from_numpy(data.view(np.int32))
    stream, length = codec_torch.encode(w)
    g_stream, g_length = golden.compress(data.view(np.float32))
    assert int(length) == g_length
    assert stream[:g_length].numpy().view(np.uint32).tobytes() == g_stream.tobytes()
    assert torch.equal(codec_torch.decode(torch.from_numpy(g_stream.view(np.int32)), w.shape), w)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(kernel_cases()))
def test_cuda_kernels_match_plain(cuda, label):
    data = kernel_cases()[label]
    w = torch.from_numpy(data.view(np.int32)).to(cuda)
    n, num_hc = w.numel(), w.numel() // HC

    stream, length = codec_cuda._encode_blocks_fp32(w)
    header, body, _ = codec_torch.encode_blocks_ref(w[: num_hc * HC].reshape(num_hc, HC))
    ref_stream, ref_length = codec_torch.encode(w)
    torch.cuda.synchronize()
    L = int(length)
    assert L == int(ref_length)
    assert torch.equal(stream[:num_hc], header)
    assert torch.equal(stream[num_hc: num_hc + int(header[-1])], body)
    assert torch.equal(stream[:L], ref_stream[:L])
    g_stream, g_length = golden.compress(data.view(np.float32))
    assert L == g_length
    assert stream[:L].cpu().numpy().view(np.uint32).tobytes() == g_stream.tobytes()

    junk = ref_stream.clone()
    junk[L:] = -1
    out = codec_cuda._decode_blocks_fp32(junk, n)
    torch.cuda.synchronize()
    assert torch.equal(out[: num_hc * HC], codec_torch.decode_blocks_ref(junk, num_hc).reshape(-1))
    assert torch.equal(out, w)
    g_out = codec_cuda._decode_blocks_fp32(torch.from_numpy(g_stream.view(np.int32)).to(cuda), n)
    torch.cuda.synchronize()
    assert torch.equal(g_out, w)


#: csrc/encode_fp32.cu's kAhead: the tickets between a CTA of the 1D encoder and the block it asks
#: the L2 for
K_AHEAD = int(re.search(r"constexpr uint32_t kAhead = (\d+);", (_build.CSRC / "encode_fp32.cu").read_text())[1])


def lookback_cases():
    """Inputs that stress the 1D encoder's look-back: one block, every length
    at its minimum (128) and at its maximum (4224), a border of 4095 words,
    and more blocks than the card holds CTAs at once; and the edges of its L2
    prefetch with HACC's border of 1,035 words: kAhead - 1 and kAhead
    blocks, where no CTA asks the L2 for a block, and kAhead + 1, where only
    block 0's CTA asks, for the last block."""
    rng = np.random.default_rng(11)
    return {
        **{f"kAhead {d:+d}: {K_AHEAD + d} blocks + 1035": normal(HC * (K_AHEAD + d) + 1035, rng)
           for d in (-1, 0, 1)},
        "one block": rng.standard_normal(HC).astype(np.float32),
        "one zero block": np.zeros(HC, np.float32),
        "all zeros, 1024 blocks": np.zeros(HC * 1024, np.float32),
        "random bits, 1024 blocks + 5": rng.integers(0, 2**32, HC * 1024 + 5, dtype=np.uint64).astype(np.uint32),
        "3 blocks + 4095": rng.standard_normal(HC * 3 + 4095).astype(np.float32),
        "2048 blocks + 17": (np.sin(np.arange(HC * 2048 + 17, dtype=np.float32) * 1e-4)
                             + 1e-3 * rng.standard_normal(HC * 2048 + 17).astype(np.float32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(lookback_cases()))
def test_cuda_encode_lookback_is_golden(cuda, label):
    """The one-pass encoder's stream is golden's byte for byte, on the first
    call, on 20 calls in a row and on calls on two CUDA streams at once: a
    call's status words are its own."""
    data = lookback_cases()[label]
    g_stream, g_length = golden.compress(data.view(np.float32))
    want = g_stream.tobytes()
    w = torch.from_numpy(data.view(np.int32)).to(cuda)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    calls = [codec_cuda._encode_blocks_fp32(w) for _ in range(20)]
    for i in range(6):
        with torch.cuda.stream(side[i % 2]):
            calls.append(codec_cuda._encode_blocks_fp32(w))
    torch.cuda.synchronize()
    for stream, length in calls:
        assert int(length) == g_length
        assert stream[: int(length)].cpu().numpy().view(np.uint32).tobytes() == want
    if label.startswith("all zeros"):
        assert np.all(np.diff(g_stream[:1024].astype(np.int64)) == 128)
    if label.startswith("random bits"):
        assert np.all(np.diff(g_stream[:1024].astype(np.int64)) == HC + HC // 32)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("label", ["one block", "3 blocks + 4095", "2048 blocks + 17"])
def test_cuda_decode_of_a_stream_view(cuda, label, offset):
    """golden's stream, exactly its length with nothing after it, as a view at
    any word offset of its storage: the decode kernel gives back the input."""
    data = lookback_cases()[label]
    g_stream, _ = golden.compress(data.view(np.float32))
    storage = torch.full((offset + g_stream.size,), -1, dtype=torch.int32, device=cuda)
    storage[offset:] = torch.from_numpy(g_stream.view(np.int32)).to(cuda)
    out = codec_cuda._decode_blocks_fp32(storage[offset:], data.size)
    torch.cuda.synchronize()
    assert out.cpu().numpy().view(np.uint32).tobytes() == data.view(np.uint32).tobytes()
    whole = codec_cuda.decompress_device(storage[offset:], data.shape)
    assert whole.cpu().numpy().view(np.uint32).tobytes() == data.view(np.uint32).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["one block", "3 blocks + 4095", "random bits, 1024 blocks + 5"])
def test_cuda_decode_of_a_truncated_stream(cuda, label):
    """A stream cut short does not fault, and decodes to what golden's words
    give when the missing ones count as zeros: the plain version on the cut
    stream with zeros after it."""
    data = lookback_cases()[label]
    g_stream, _ = golden.compress(data.view(np.float32))
    num_hc, L = data.size // HC, g_stream.size
    full = torch.from_numpy(g_stream.view(np.int32)).to(cuda)
    for cut in sorted({num_hc, num_hc + 1, num_hc + 130, L // 2, L * 2 // 3, L - 1}):
        zeros_past = torch.zeros(L + HC + HC // 32, dtype=torch.int32, device=cuda)
        zeros_past[:cut] = full[:cut]
        out = codec_cuda._decode_blocks_fp32(full[:cut].clone(), data.size)
        torch.cuda.synchronize()
        assert torch.equal(out[: num_hc * HC], codec_torch.decode_blocks_ref(zeros_past, num_hc).reshape(-1)), cut


@pytest.mark.cuda
def test_cuda_encode_of_a_view_from_its_second_element(cuda):
    """A caller's tensor viewed from its second element, 4 bytes past 16-byte
    alignment, is copied once (``COPIES["align1d"]``) before the 1D encoder,
    whose bulk copy takes 16-byte aligned blocks, launches once on the copy,
    and its stream is still golden's byte for byte."""
    data = lookback_cases()[f"kAhead +1: {K_AHEAD + 1} blocks + 1035"]
    buf = torch.from_numpy(np.concatenate([np.zeros(1, np.float32), data])).to(cuda)
    view = buf[1:]
    assert view.data_ptr() % 16 == 4
    copies, launches = codec_cuda.COPIES["align1d"], codec_cuda.LAUNCHES["encode"]
    stream, length = codec_cuda.compress_device(view)
    assert codec_cuda.COPIES["align1d"] == copies + 1 and codec_cuda.LAUNCHES["encode"] == launches + 1
    g_stream, g_length = golden.compress(data)
    assert int(length) == g_length
    assert stream[:g_length].cpu().numpy().view(np.uint32).tobytes() == g_stream.tobytes()


def one_pass_1d(blocks: np.ndarray, lane0_reads: bool = True) -> np.ndarray:
    """The 1D encoder's pass from a block as its bulk copy leaves it in
    shared memory to the transformed words (csrc/encode_fp32.cu's
    transform_run_1d), lane by lane in numpy: thread t of 256 takes the 16
    bytes q = t + 256k for k < 4, words 4q .. 4q + 3, each rotated left by
    one; the rotated word before them is the lane before's last word
    (``__shfl_up_sync`` by 1, which gives lane 0 its own), and lane 0 reads
    word 4q - 1 of the block itself (none for q = 0: 0); each word less the
    rotated word before it, then complement-negative. ``lane0_reads=False``
    drops lane 0's read, so lane 0 keeps the shuffle's word. ``blocks``:
    (nb, 4096) uint32. Returns the words in block order."""
    nb = blocks.shape[0]
    words = blocks.astype(np.uint32)
    rot = (words << np.uint32(1)) | (words >> np.uint32(31))
    regs = rot.reshape(nb, 4, 8, 32, 4)  # [block, k, warp, lane, j]: q = 256k + 32 warp + lane
    shuffled = np.concatenate([regs[..., :1, 3], regs[..., :-1, 3]], axis=-1)  # lane l - 1's last word
    q = np.arange(HC // 4).reshape(4, 8, 32)
    if lane0_reads:
        own = np.where(q > 0, rot[:, np.maximum(4 * q - 1, 0)], np.uint32(0))[..., 0]
        shuffled[..., 0] = own
    before = np.concatenate([shuffled[..., None], regs[..., :3]], axis=-1)
    d = regs - before
    return np.where(d >> np.uint32(31) == 1, d ^ np.uint32(0x7FFFFFFF), d).reshape(nb, HC)


ONE_PASS_CASES = {
    "normal values": lambda: normal((8, HC), 80).view(np.uint32),
    "random bits": lambda: np.random.default_rng(81).integers(0, 2**32, (8, HC), dtype=np.uint64).astype(np.uint32),
    "special floats": lambda: special_floats(normal(9 * HC, 82)).view(np.uint32).reshape(9, HC),
    "all-equal blocks": lambda: np.repeat(np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x3FC00000], np.uint32),
                                          HC).reshape(-1, HC),
}


@pytest.mark.parametrize("label", list(ONE_PASS_CASES))
def test_the_1d_pass_model_gives_the_forward_transform(label):
    blocks = ONE_PASS_CASES[label]()
    with np.errstate(over="ignore"):
        assert np.array_equal(one_pass_1d(blocks), golden.block_transform(blocks, 1))


@pytest.mark.parametrize("label", ["normal values", "random bits"])
def test_the_1d_pass_model_needs_lane_0s_read(label):
    """Without lane 0's read of word 4q - 1, the first word of each 128
    words that a warp takes at once (32 lanes of 16 bytes) takes the wrong
    word before it: the shuffle gives lane 0 its own last word."""
    blocks = ONE_PASS_CASES[label]()
    with np.errstate(over="ignore"):
        wrong = one_pass_1d(blocks, lane0_reads=False) != golden.block_transform(blocks, 1)
    assert np.array_equal(np.flatnonzero(wrong.any(axis=0)), np.arange(0, HC, 128))


def test_the_1d_pass_writes_a_warp_to_32_banks():
    """The padded slots (one pad word after every 32) of a warp's 32 words
    4q + j, for each j, fall in 32 different banks of shared memory."""
    q = np.arange(HC // 4).reshape(-1, 32)
    for j in range(4):
        i = 4 * q + j
        banks = (i + (i >> 5)) % 32
        assert all(len(set(row)) == 32 for row in banks.tolist()), j


# ------------------------------------------------------------ 2D/3D


def as_tensor(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_block_transform_matches_golden(dims):
    blocks = np.random.default_rng(dims).integers(0, 2**32, (5, HC), dtype=np.uint64).astype(np.uint32)
    blocks[0] = 0
    blocks[1] = blocks[1, 0]  # a constant block
    ours = codec_torch.block_transform(as_tensor(blocks), dims).numpy().view(np.uint32)
    assert np.array_equal(ours, golden.block_transform(blocks, dims))
    back = codec_torch.inverse_block_transform(torch.from_numpy(ours.view(np.int32)), dims)
    assert np.array_equal(back.numpy().view(np.uint32), blocks)
    inv = codec_torch.inverse_block_transform(as_tensor(blocks), dims).numpy().view(np.uint32)
    assert np.array_equal(inv, golden.inverse_block_transform(blocks, dims))


@pytest.mark.parametrize("shape", [(128, 512), (16, 32, 128)])
def test_encode_nd_matches_pallas_interior(pallas, shape):
    """The plain encode of a tiled grid against B3 (the tiled Pallas encoder)."""
    data = normal(shape, len(shape))
    words = data.view(np.uint32)
    dims, num_hc = len(shape), fmt.num_hypercubes(shape)
    header, body, _ = codec_torch.encode_blocks_ref(
        codec_torch.gather_blocks(as_tensor(words), shape), dims)

    G = pallas._g_tiled(shape, dims, pallas.G_ENC)
    body2d, hdr2d = pallas._encode_interior_fp32(words, shape, num_hc, G)
    jax_header = np.asarray(hdr2d)[:, :G].reshape(-1)[:num_hc]
    jax_body = np.asarray(body2d).reshape(-1)[num_hc: num_hc + int(jax_header[-1])]
    assert np.array_equal(header.numpy().view(np.uint32), jax_header)
    assert np.array_equal(body.numpy().view(np.uint32), jax_body)


@pytest.mark.parametrize("shape", [(128, 512), (16, 32, 128)])
def test_decode_nd_matches_pallas_interior(pallas, shape):
    """The plain decode of a tiled grid against B4 (the tiled Pallas decoder),
    whose starts come in padded-grid order (_padded_block_ids)."""
    data = normal(shape, 10 + len(shape))
    stream, _ = golden.compress(data)
    dims, num_hc = len(shape), fmt.num_hypercubes(shape)
    out = torch.empty(shape, dtype=torch.int32)
    codec_torch.scatter_blocks(codec_torch.decode_blocks_ref(as_tensor(stream), num_hc, dims), shape, out)

    offsets = stream[:num_hc].astype(np.int32)
    starts = num_hc + np.concatenate([[0], offsets[:-1]]).astype(np.int32)
    G, gx = pallas._g_tiled_padded(shape, dims, pallas.G_DEC, exact_cap=pallas.G_EXACT_CAP)
    ids = pallas._padded_block_ids(shape, dims, G, gx)
    lanes = pallas.LANES
    rows = -(-(stream.size + pallas.WIN_ROWS * lanes) // lanes)
    padded = np.zeros(rows * lanes, np.uint32)
    padded[: stream.size] = stream
    theirs = pallas._decode_interior_fp32(padded.reshape(rows, lanes), starts[ids], shape, num_hc, G, gx)

    assert np.array_equal(out.numpy().view(np.uint32), np.asarray(theirs))
    assert np.array_equal(out.numpy().view(np.uint32), data.view(np.uint32))


def test_gather_route_matches_pallas_blocks(pallas):
    """(128, 192): a minor block-grid axis of 3 takes the JAX package's gather
    route into B1 with dims=2; the plain gather and encode give its words."""
    shape = (128, 192)
    data = normal(shape, 7)
    nb = fmt.num_hypercubes(shape)
    blocks = codec_torch.gather_blocks(as_tensor(data.view(np.uint32)), shape)
    assert np.array_equal(blocks.numpy().view(np.uint32), golden.gather_blocks(data.view(np.uint32)))
    header, body, _ = codec_torch.encode_blocks_ref(blocks, 2)

    G = pallas.G_ENC
    padded = np.zeros((-(-nb // G) * G, HC), np.uint32)
    padded[:nb] = blocks.numpy().view(np.uint32)
    body2d, hdr2d = pallas._encode_blocks_fp32(padded, 2, nb)
    jax_header = np.asarray(hdr2d)[:, :G].reshape(-1)[:nb]
    assert np.array_equal(header.numpy().view(np.uint32), jax_header)
    assert np.array_equal(body.numpy().view(np.uint32),
                          np.asarray(body2d).reshape(-1)[nb: nb + int(jax_header[-1])])


#: every pattern of bordered axes in 1-3 dims, and grids that are all border
BORDER_SHAPES = [
    (4096 * 2,), (4096 * 2 + 5,), (100,), (0,),
    (128, 192), (130, 192), (128, 193), (130, 513), (63, 100), (64, 10), (1800, 130),
    (32, 32, 32), (33, 32, 32), (32, 33, 32), (32, 32, 33), (33, 33, 32), (33, 32, 33),
    (32, 33, 33), (17, 32, 129), (15, 16, 200), (16, 16, 15), (40, 3, 50),
]


@pytest.mark.parametrize("shape", BORDER_SHAPES, ids=str)
def test_border_offsets_match_border_slices(shape):
    runs = fmt.border_slices(shape)
    expected = (np.concatenate([np.arange(off, off + cnt) for off, cnt in runs]) if runs
                else np.zeros(0, np.int64))
    assert np.array_equal(codec_torch.border_offsets(shape).numpy(), expected)


@pytest.mark.parametrize("shape", BORDER_SHAPES, ids=str)
def test_border_take_and_place_follow_offsets(shape):
    words = torch.arange(int(np.prod(shape)), dtype=torch.int32).reshape(shape) * 7 + 1
    values = codec_torch.border_take(words, shape)
    assert torch.equal(values, words.reshape(-1)[codec_torch.border_offsets(shape)])
    out = torch.zeros(shape, dtype=torch.int32)
    codec_torch.border_place(out, values, shape)
    placed = torch.zeros(int(np.prod(shape)), dtype=torch.int32)
    placed[codec_torch.border_offsets(shape)] = values
    assert torch.equal(out.reshape(-1), placed)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(nd_kernel_cases()))
def test_cuda_nd_kernels_match_plain(cuda, label):
    data = nd_kernel_cases()[label]
    shape, dims = data.shape, data.ndim
    num_hc = fmt.num_hypercubes(shape)
    w = torch.from_numpy(data.view(np.int32)).to(cuda)
    ref_stream, ref_length = codec_torch.encode(w)
    L = int(ref_length)
    g_stream, g_length = golden.compress(data.view(np.float32))
    assert L == g_length
    junk = ref_stream.clone()
    junk[L:] = -1
    if num_hc == 0:  # all border: the glue copies, no kernel runs
        stream, length = codec_cuda.compress_device(w)
        assert int(length) == L and torch.equal(stream, ref_stream)
        assert torch.equal(codec_cuda.decompress_device(junk, shape, torch.int32), w)
        return

    stream, length = codec_cuda._encode_interior_fp32(w)
    header, body, _ = codec_torch.encode_blocks_ref(codec_torch.gather_blocks(w, shape), dims)
    torch.cuda.synchronize()
    assert int(length) == L
    assert torch.equal(stream[:num_hc], header)
    assert torch.equal(stream[num_hc: num_hc + int(header[-1])], body)
    assert stream[:L].cpu().numpy().view(np.uint32).tobytes() == g_stream.tobytes()

    out = codec_cuda._decode_interior_fp32(junk, shape)
    torch.cuda.synchronize()
    assert torch.equal(codec_torch.gather_blocks(out, shape),
                       codec_torch.decode_blocks_ref(junk, num_hc, dims))
    assert torch.equal(out, w)
    g_out = codec_cuda._decode_interior_fp32(torch.from_numpy(g_stream.view(np.int32)).to(cuda), shape)
    torch.cuda.synchronize()
    assert torch.equal(g_out, w)


#: the 2D/3D grids of nd_kernel_cases with at least one whole block
ND_LABELS = [label for label in nd_kernel_cases() if "all border" not in label]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("label", ND_LABELS)
def test_cuda_nd_decode_of_a_stream_view(cuda, label, offset):
    """golden's stream, exactly its length with nothing after it, as a view at
    any word offset of its storage: the nd decode kernel gives back the input."""
    data = nd_kernel_cases()[label]
    g_stream, _ = golden.compress(data.view(np.float32))
    storage = torch.full((offset + g_stream.size,), -1, dtype=torch.int32, device=cuda)
    storage[offset:] = torch.from_numpy(g_stream.view(np.int32)).to(cuda)
    out = codec_cuda._decode_interior_fp32(storage[offset:], data.shape)
    torch.cuda.synchronize()
    assert out.cpu().numpy().view(np.uint32).tobytes() == data.view(np.uint32).tobytes()
    whole = codec_cuda.decompress_device(storage[offset:], data.shape, torch.int32)
    assert whole.cpu().numpy().view(np.uint32).tobytes() == data.view(np.uint32).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("label", ND_LABELS)
def test_cuda_nd_decode_of_a_truncated_stream(cuda, label):
    """A stream cut short does not fault, and its blocks decode to what
    golden's words give when the missing ones count as zeros."""
    data = nd_kernel_cases()[label]
    shape, dims = data.shape, data.ndim
    g_stream, _ = golden.compress(data.view(np.float32))
    num_hc, L = fmt.num_hypercubes(shape), g_stream.size
    full = torch.from_numpy(g_stream.view(np.int32)).to(cuda)
    for cut in sorted({num_hc, num_hc + 1, num_hc + 130, L // 2, L * 2 // 3, L - 1}):
        zeros_past = torch.zeros(L + HC + HC // 32, dtype=torch.int32, device=cuda)
        zeros_past[:cut] = full[:cut]
        out = codec_cuda._decode_interior_fp32(full[:cut].clone(), shape)
        torch.cuda.synchronize()
        assert torch.equal(codec_torch.gather_blocks(out, shape),
                           codec_torch.decode_blocks_ref(zeros_past, num_hc, dims)), cut


@pytest.mark.cuda
@pytest.mark.parametrize("label", ND_LABELS)
def test_cuda_nd_encode_lookback_is_golden(cuda, label):
    """The one-pass nd encoder's stream is golden's byte for byte on 20 calls
    in a row and on calls on two CUDA streams at once: a call's status words
    are its own."""
    data = nd_kernel_cases()[label]
    g_stream, g_length = golden.compress(data.view(np.float32))
    want = g_stream.tobytes()
    w = torch.from_numpy(data.view(np.int32)).to(cuda)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    calls = [codec_cuda._encode_interior_fp32(w) for _ in range(20)]
    for i in range(6):
        with torch.cuda.stream(side[i % 2]):
            calls.append(codec_cuda._encode_interior_fp32(w))
    torch.cuda.synchronize()
    for stream, length in calls:
        assert int(length) == g_length
        assert stream[: int(length)].cpu().numpy().view(np.uint32).tobytes() == want


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(nd_border_shapes()))
def test_cuda_nd_bordered_grids_are_golden(cuda, label):
    """Through the entry points: a border of more CTAs than the card holds at
    once (the encoder's border CTAs wait for the last block, and must not
    keep it from starting), and unaligned rows with a border on every axis.
    The run ends, the stream is golden's and the round trip is bit-exact."""
    shape = nd_border_shapes()[label]
    data = normal(shape, 0)
    g_stream, g_length = golden.compress(data)
    x = torch.from_numpy(data).to(cuda)
    for _ in range(3):
        stream, length = codec_cuda.compress_device(x)
        torch.cuda.synchronize()
        assert int(length) == g_length
        assert stream[: int(length)].cpu().numpy().view(np.uint32).tobytes() == g_stream.tobytes()
    out = codec_cuda.decompress_device(torch.from_numpy(g_stream.view(np.int32)).to(cuda), shape)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), x.view(torch.int32))


# ------------------------------------------------------------ fp64 (B5-B8)


def as_tensor64(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64))


def pallas_stream2d(pallas, stream: np.ndarray) -> np.ndarray:
    """A u32 stream zero-padded by the decoder's window, as 128-lane rows."""
    lanes = pallas.LANES
    rows = -(-(stream.size + 2 * pallas.WIN_ROWS * lanes) // lanes)
    padded = np.zeros(rows * lanes, np.uint32)
    padded[: stream.size] = stream
    return padded.reshape(rows, lanes)


def u64_starts(stream: np.ndarray, nb: int) -> np.ndarray:
    """Block starts in u64 words including the header, as
    codec_pallas._decode_fp64_device builds them."""
    offsets = stream[:nb].astype(np.int32)
    return fmt.header_words(nb, 64) + np.concatenate([[0], offsets[:-1]]).astype(np.int32)


def test_words_and_planes_match_u64pair():
    words = np.random.default_rng(40).integers(0, 2**64, (3, 5, 7), dtype=np.uint64)
    words.reshape(-1)[:3] = [0, 2**63, 2**64 - 1]
    lo, hi = u64pair.split(words)
    t = interop.words_from_planes(lo, hi)
    assert t.dtype == torch.int64 and t.shape == words.shape
    assert np.array_equal(t.numpy().view(np.uint64), u64pair.join(lo, hi))
    got_lo, got_hi = interop.planes_from_words(t)
    assert np.array_equal(got_lo, lo) and np.array_equal(got_hi, hi)
    assert got_lo.dtype == np.uint32 and got_lo.shape == words.shape


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_block_transform_int64_matches_golden(dims):
    blocks = np.random.default_rng(50 + dims).integers(0, 2**64, (5, HC), dtype=np.uint64)
    blocks[0] = 0
    blocks[1] = blocks[1, 0]  # a constant block
    blocks[2, :64] = [0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1] * 9 + [7]
    ours = codec_torch.block_transform(as_tensor64(blocks), dims).numpy().view(np.uint64)
    assert np.array_equal(ours, golden.block_transform(blocks, dims))
    back = codec_torch.inverse_block_transform(torch.from_numpy(ours.view(np.int64)), dims)
    assert np.array_equal(back.numpy().view(np.uint64), blocks)
    inv = codec_torch.inverse_block_transform(as_tensor64(blocks), dims).numpy().view(np.uint64)
    assert np.array_equal(inv, golden.inverse_block_transform(blocks, dims))


def test_transpose_bits_int64_matches_jax_package():
    chunks = np.random.default_rng(60).integers(0, 2**64, (3, 64, 64), dtype=np.uint64)
    chunks[0] &= np.uint64(0x8000_0000_0000_0001)  # sparse rows: the top and bottom bits
    chunks[1, ::3] = 0
    got = bitops.transpose_bits(as_tensor64(chunks))
    assert np.array_equal(got.numpy().view(np.uint64), ref_bitops.transpose_bits(chunks, np))
    assert torch.equal(bitops.transpose_bits(got), as_tensor64(chunks))  # an involution


@pytest.mark.parametrize("nb", [8, 13])
def test_encode_blocks_ref_fp64_matches_pallas(pallas, nb):
    """The plain fp64 encode against B5, fed the words as (lo, hi) planes."""
    blocks = normal((nb, HC), nb, np.float64).view(np.uint64)
    header, body, lengths = codec_torch.encode_blocks_ref(as_tensor64(blocks))

    G = pallas.G_ENC
    padded = torch.zeros((-(-nb // G) * G, HC), dtype=torch.int64)
    padded[:nb] = as_tensor64(blocks)
    lo, hi = interop.planes_from_words(padded)
    body2d, hdr2d = pallas._encode_blocks_fp64(lo, hi, 1, nb)
    jax_header = np.asarray(hdr2d)[:, :G].reshape(-1)[:nb]
    hw, body_total = fmt.header_words(nb, 64), int(jax_header[-1])
    jax_body = np.asarray(body2d).reshape(-1)[2 * hw: 2 * (hw + body_total)]

    assert np.array_equal(header.numpy().view(np.uint32), jax_header)
    assert np.array_equal(body.numpy().view(np.uint32), jax_body)
    assert np.array_equal(np.cumsum(lengths.numpy()), jax_header)


@pytest.mark.parametrize("nb", [8, 13])
def test_decode_blocks_ref_fp64_matches_pallas(pallas, nb):
    """The plain fp64 decode against B7, whose starts count u64 words from
    the stream's start, padded to a multiple of G_DEC64 with the last one."""
    blocks = normal((nb, HC), 100 + nb, np.float64).view(np.uint64)
    stream, _ = golden.compress(blocks.reshape(-1).view(np.float64))
    ours = codec_torch.decode_blocks_ref(torch.from_numpy(stream.view(np.int32)), nb, 1, 64)

    starts = u64_starts(stream, nb)
    nb_pad = -(-nb // pallas.G_DEC64) * pallas.G_DEC64
    starts = np.concatenate([starts, np.full(nb_pad - nb, starts[-1], np.int32)])
    lo, hi = pallas._decode_blocks_fp64(pallas_stream2d(pallas, stream), starts, 1, nb)
    theirs = interop.words_from_planes(np.asarray(lo)[:nb], np.asarray(hi)[:nb])

    assert torch.equal(ours, theirs)
    assert np.array_equal(ours.numpy().view(np.uint64), blocks)


@pytest.mark.parametrize("shape", [(128, 512), (16, 32, 128)])
def test_encode_nd_fp64_matches_pallas_interior(pallas, shape):
    """The plain encode of a tiled fp64 grid against B6."""
    words = normal(shape, len(shape), np.float64).view(np.uint64)
    dims, num_hc = len(shape), fmt.num_hypercubes(shape)
    header, body, _ = codec_torch.encode_blocks_ref(
        codec_torch.gather_blocks(as_tensor64(words), shape), dims)

    G = pallas._g_tiled(shape, dims, pallas.G_ENC)
    lo, hi = u64pair.split(words)
    body2d, hdr2d = pallas._encode_interior_fp64(lo, hi, shape, num_hc, G)
    jax_header = np.asarray(hdr2d)[:, :G].reshape(-1)[:num_hc]
    hw, body_total = fmt.header_words(num_hc, 64), int(jax_header[-1])
    assert np.array_equal(header.numpy().view(np.uint32), jax_header)
    assert np.array_equal(body.numpy().view(np.uint32),
                          np.asarray(body2d).reshape(-1)[2 * hw: 2 * (hw + body_total)])


@pytest.mark.parametrize("shape", [(128, 512), (16, 32, 128)])
def test_decode_nd_fp64_matches_pallas_interior(pallas, shape):
    """The plain decode of a tiled fp64 grid against B8, whose starts come in
    padded-grid order (_padded_block_ids)."""
    words = normal(shape, 10 + len(shape), np.float64).view(np.uint64)
    stream, _ = golden.compress(words.view(np.float64))
    dims, num_hc = len(shape), fmt.num_hypercubes(shape)
    out = torch.empty(shape, dtype=torch.int64)
    codec_torch.scatter_blocks(
        codec_torch.decode_blocks_ref(torch.from_numpy(stream.view(np.int32)), num_hc, dims, 64), shape, out)

    G, gx = pallas._g_tiled_padded(shape, dims, pallas.G_DEC64)
    ids = pallas._padded_block_ids(shape, dims, G, gx)
    lo, hi = pallas._decode_interior_fp64(pallas_stream2d(pallas, stream), u64_starts(stream, num_hc)[ids],
                                          shape, num_hc, G, gx)
    assert torch.equal(out, interop.words_from_planes(lo, hi))
    assert np.array_equal(out.numpy().view(np.uint64), words)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(fp64_kernel_cases()))
def test_cuda_fp64_kernels_match_plain(cuda, label):
    data = fp64_kernel_cases()[label]
    shape, dims = data.shape, data.ndim
    num_hc = fmt.num_hypercubes(shape)
    w = torch.from_numpy(data.view(np.int64)).to(cuda)
    ref_stream, ref_length = codec_torch.encode(w)
    L = int(ref_length)
    g_stream, g_length = golden.compress(data)
    assert L == 2 * g_length
    junk = ref_stream.clone()
    junk[L:] = -1
    if num_hc == 0:  # all border: the glue copies, no kernel runs
        stream, length = codec_cuda.compress_device(w)
        assert int(length) == L and torch.equal(stream, ref_stream)
        assert torch.equal(codec_cuda.decompress_device(junk, shape, torch.int64), w)
        return

    if dims == 1:
        encode, decode = codec_cuda._encode_blocks_fp64, lambda s: codec_cuda._decode_blocks_fp64(s, shape[0])
    else:
        encode, decode = codec_cuda._encode_interior_fp64, lambda s: codec_cuda._decode_interior_fp64(s, shape)
    stream, length = encode(w)
    header, body, _ = codec_torch.encode_blocks_ref(codec_torch.gather_blocks(w, shape), dims)
    torch.cuda.synchronize()
    hw2 = 2 * fmt.header_words(num_hc, 64)
    assert int(length) == L
    assert torch.equal(stream[:num_hc], header)
    assert torch.equal(stream[hw2: hw2 + 2 * int(header[-1])].view(torch.int64), body)
    assert stream[:L].cpu().numpy().view(np.uint32).tobytes() == g_stream.tobytes()

    out = decode(junk)
    torch.cuda.synchronize()
    assert torch.equal(codec_torch.gather_blocks(out, shape),
                       codec_torch.decode_blocks_ref(junk, num_hc, dims, 64))
    assert torch.equal(out, w)
    g_out = decode(torch.from_numpy(g_stream.view(np.int32)).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(g_out, w)


def lookback64_cases():
    """Inputs that stress the fp64 encoders' look-back: 1D at 2048 blocks + 17
    with every length at its minimum (64) and at its maximum (4160), an odd
    block count (the header's pad entry) with a border of 4095 words, and
    bordered 2D and 3D grids with a border on every axis, the 3D one with
    1085 border CTAs, more than the card holds at once."""
    rng = np.random.default_rng(12)

    def zero_run(shape):
        d = rng.standard_normal(shape)
        d.reshape(-1)[:200] = 0
        return d

    return {
        "1d all zeros, 2048 blocks + 17": np.zeros(HC * 2048 + 17),
        "1d random bits, 2048 blocks + 17": rng.integers(0, 2**64, HC * 2048 + 17, dtype=np.uint64).view(np.float64),
        "1d 3 blocks + 4095": zero_run(HC * 3 + 4095),
        "2d border on both axes (4100, 1030)": zero_run((4100, 1030)),
        "3d border on every axis, 1085 border CTAs (20, 1030, 1030)": zero_run((20, 1030, 1030)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(lookback64_cases()))
def test_cuda_fp64_encode_lookback_is_golden(cuda, label):
    """The one-pass fp64 encoders' stream is golden's byte for byte, on 20
    calls in a row and on calls on two CUDA streams at once: a call's status
    words are its own, and border CTAs that wait for the last block do not
    keep it from starting."""
    data = lookback64_cases()[label]
    g_stream, g_length = golden.compress(data)
    want = g_stream.tobytes()
    w = torch.from_numpy(data.view(np.int64)).to(cuda)
    encode = codec_cuda._encode_blocks_fp64 if data.ndim == 1 else codec_cuda._encode_interior_fp64
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    calls = [encode(w) for _ in range(20)]
    for i in range(6):
        with torch.cuda.stream(side[i % 2]):
            calls.append(encode(w))
    torch.cuda.synchronize()
    for stream, length in calls:
        assert int(length) == 2 * g_length
        assert stream[: int(length)].cpu().numpy().tobytes() == want
    header = g_stream.view(np.uint32)[:2048].astype(np.int64)
    if label.startswith("1d all zeros"):
        assert np.all(np.diff(header) == HC // 64)
    if label.startswith("1d random bits"):
        assert np.all(np.diff(header) == HC + HC // 64)


#: the fp64 cases of fp64_kernel_cases with at least one whole block
FP64_LABELS = [label for label in fp64_kernel_cases() if "all border" not in label]


def fp64_decoder(shape):
    """B7 for 1D shapes, B8 for 2D/3D ones."""
    if len(shape) == 1:
        return lambda s: codec_cuda._decode_blocks_fp64(s, shape[0])
    return lambda s: codec_cuda._decode_interior_fp64(s, shape)


def fp64_truncations(num_hc: int, L: int) -> list[int]:
    """Where an fp64 stream of L u32 words is cut: even u32 counts from the
    end of the header (its pad word in) to two words short of the end."""
    hw2 = 2 * fmt.header_words(num_hc, 64)
    return sorted({hw2, hw2 + 2, hw2 + 130, L // 4 * 2, L * 2 // 3 // 2 * 2, L - 2} - {L})


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("label", FP64_LABELS)
def test_cuda_fp64_decode_of_a_stream_view(cuda, label, offset):
    """golden's fp64 stream, exactly its length with nothing after it, as a
    view at u64 word offsets 0-3 of its storage (so the run's 16-byte skew
    takes both values): B7/B8 give back the input, also through
    decompress_device."""
    data = fp64_kernel_cases()[label]
    g_stream, _ = golden.compress(data)
    g32 = torch.from_numpy(np.ascontiguousarray(g_stream).view(np.int32)).to(cuda)
    storage = torch.full((2 * offset + g32.numel(),), -1, dtype=torch.int32, device=cuda)
    storage[2 * offset:] = g32
    out = fp64_decoder(data.shape)(storage[2 * offset:])
    torch.cuda.synchronize()
    assert out.cpu().numpy().tobytes() == data.tobytes()
    whole = codec_cuda.decompress_device(storage[2 * offset:], data.shape, torch.float64)
    assert whole.cpu().numpy().tobytes() == data.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("label", FP64_LABELS)
def test_cuda_fp64_decode_at_an_odd_u32_offset(cuda, label):
    """An fp64 stream at an odd u32 offset of its storage is not 8-byte
    aligned: the kernels refuse it, and decompress_device decodes a
    realigned clone."""
    data = fp64_kernel_cases()[label]
    g_stream, _ = golden.compress(data)
    g32 = torch.from_numpy(np.ascontiguousarray(g_stream).view(np.int32)).to(cuda)
    for offset in (1, 3):
        storage = torch.full((offset + g32.numel(),), -1, dtype=torch.int32, device=cuda)
        storage[offset:] = g32
        with pytest.raises(ValueError, match="8-byte aligned"):
            fp64_decoder(data.shape)(storage[offset:])
        out = codec_cuda.decompress_device(storage[offset:], data.shape, torch.float64)
        torch.cuda.synchronize()
        assert out.cpu().numpy().tobytes() == data.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("label", FP64_LABELS)
def test_cuda_fp64_decode_of_a_truncated_stream(cuda, label):
    """An fp64 stream cut short at even u32 counts does not fault, and its
    blocks decode to what the plain version gives on the cut stream with
    zeros after it."""
    data = fp64_kernel_cases()[label]
    shape, dims = data.shape, data.ndim
    g_stream, _ = golden.compress(data)
    full = torch.from_numpy(np.ascontiguousarray(g_stream).view(np.int32)).to(cuda)
    num_hc, L = fmt.num_hypercubes(shape), full.numel()
    for cut in fp64_truncations(num_hc, L):
        zeros_past = torch.zeros(L + 2 * (HC + HC // 64), dtype=torch.int32, device=cuda)
        zeros_past[:cut] = full[:cut]
        out = fp64_decoder(shape)(full[:cut].clone())
        torch.cuda.synchronize()
        assert torch.equal(codec_torch.gather_blocks(out, shape),
                           codec_torch.decode_blocks_ref(zeros_past, num_hc, dims, 64)), cut
