"""The port's block-parallel layer (``ndzip_tpu_torch.parallel.sharded``): the
cases of tests/test_sharded.py that apply, on meshes of CPU devices
(``["cpu"] * n``, shards through ``codec_torch``). Every stream is held to
``ndzip_tpu.golden.compress`` and to ``ndzip_tpu.parallel.compress_sharded``
on the conftest's 8-device CPU mesh, byte for byte, on the same inputs
(``numpy.random.default_rng``); every round trip is bit-exact. Tolerance
zero. Also: fp64 shards with odd block counts (the header's pad entry) under
both parities of the total, shards with no block, the units of both paths'
lengths, the ``sharded`` backend of the API and the CLI, and
``dryrun_multichip``.

On a card (marker ``cuda``, skipped elsewhere) the same cases run on
``["cuda"] * 4``: ``NDZIP_TPU_TESTS_TPU=1 python -m pytest
tests/test_torch_sharded.py -m cuda`` (the variable keeps tests/conftest.py
from setting up JAX, which the card's machine need not have; JAX is imported
inside a fixture here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch import api, cli  # noqa: E402
from ndzip_tpu_torch import format as fmt  # noqa: E402
from ndzip_tpu_torch.parallel import (compress_sharded, compress_sharded_device,  # noqa: E402
                                      decompress_sharded, decompress_sharded_device,
                                      dryrun_multichip, make_mesh, sharded)

CPU8 = ["cpu"] * 8

SHAPES = [
    ((4096 * 16,), np.float32),       # 16 blocks / 8 shards
    ((4096 * 16 + 33,), np.float32),  # + border
    ((512, 70), np.float32),          # 8 block-rows, minor border
    ((128, 64, 33), np.float64),      # 3D fp64 with border
]

# uneven block grids, including fewer block rows than shards
UNEVEN = [
    ((4096 * 3,), np.float32),            # 3 blocks / 8 shards: five shards own nothing
    ((4096 * 7 + 17, 130), np.float32),   # prime-ish rows, minor border
    ((4096 * 13 + 5,), np.float64),       # 13 blocks / 8 shards + border
    ((16 * 7, 16 * 3, 40), np.float32),   # 7 block-rows of 3 blocks, border
]

# fp64 shards with odd block counts: each shard's stream has a pad entry that
# the global header must not take; the global pad comes where the total is odd
PAD64 = [
    ((16 * 3, 16, 17), 8),       # 1 + 1 + 1 blocks: odd shards, odd total
    ((16 * 4, 16, 17), 8),       # 1 block each of 4 shards: odd shards, even total
    ((4096 * 5 + 3,), 3),        # 2 + 2 + 1: odd total
    ((64 * 5, 64 * 3 + 5), 2),   # 9 + 6: odd total
    ((64 * 4, 64 * 3 + 5), 4),   # 3 blocks each: odd shards, even total
]


def make_data(shape, dtype, seed):
    data = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    data.reshape(-1)[:100] = 0
    return data


def word_view(a):
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.fixture(scope="module")
def jax_sharded():
    """``ndzip_tpu.parallel.compress_sharded`` on the conftest's 8-device CPU
    mesh. JAX is imported here, not at the top, so that the card's machine,
    which has no JAX, collects this file."""
    import jax

    from ndzip_tpu.parallel import sharded as jax_layer

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual CPU devices")
    mesh = jax_layer.make_mesh(devs[:8])
    return lambda data: jax_layer.compress_sharded(data, mesh)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return ["cuda"] * 4


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """The ``sharded`` backend on eight CPU shards: what ``make_mesh()`` gives
    is the only thing the backend does not take from its arguments."""
    monkeypatch.setattr(sharded, "make_mesh", lambda devices=None: tuple(torch.device(d) for d in CPU8))


def check_stream(data, mesh, jax_compress=None):
    expect, elen = golden.compress(data)
    stream, length = compress_sharded(data, mesh)
    assert length == elen
    assert stream.tobytes() == expect.tobytes()
    if jax_compress is not None:
        jstream, jlength = jax_compress(data)
        assert jlength == length and np.asarray(jstream).tobytes() == stream.tobytes()
    return expect


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=str)
def test_sharded_stream_bit_identical(jax_sharded, shape, dtype):
    check_stream(make_data(shape, dtype, 1), CPU8, jax_sharded)


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=str)
def test_sharded_decode(shape, dtype):
    data = make_data(shape, dtype, 2)
    stream, _ = golden.compress(data)
    out = decompress_sharded(stream, shape, dtype, CPU8)
    assert out.dtype == data.dtype and np.array_equal(word_view(out), word_view(data))


@pytest.mark.parametrize("shape,dtype", UNEVEN, ids=str)
def test_sharded_uneven_roundtrip(jax_sharded, shape, dtype):
    data = make_data(shape, dtype, 3)
    expect = check_stream(data, CPU8, jax_sharded)
    out = decompress_sharded(expect, shape, dtype, CPU8)
    assert np.array_equal(word_view(out), word_view(data))


@pytest.mark.parametrize("shape,n", PAD64, ids=str)
def test_sharded_fp64_pad_entries(shape, n):
    grid0 = fmt.grid_shape(shape)[0]
    per_shard = [fmt.num_hypercubes(((r1 - r0),) + shape[1:]) for r0, r1 in sharded._shard_grid(shape, n)]
    assert sum(per_shard) == fmt.num_hypercubes(shape) and any(b % 2 for b in per_shard), (grid0, per_shard)
    data = make_data(shape, np.float64, 4)
    expect = check_stream(data, ["cpu"] * n)
    out = decompress_sharded(expect, shape, np.float64, ["cpu"] * n)
    assert np.array_equal(word_view(out), word_view(data))


def test_pad_cases_cover_both_parities():
    totals = {fmt.num_hypercubes(shape) % 2 for shape, _ in PAD64}
    assert totals == {0, 1}


@pytest.mark.parametrize("shape,dtype", SHAPES + UNEVEN, ids=str)
@pytest.mark.parametrize("n", [3, 5, 8])
def test_shard_grid_owns_the_jax_layers_blocks(shape, dtype, n):
    """Shard k owns the blocks that the JAX layer's shard k holds unpadded
    (``ndzip_tpu/parallel/sharded.py:_shard_grid``'s ``real``), and the
    slabs tile axis 0."""
    from ndzip_tpu.parallel import sharded as jax_layer

    _, _, real = jax_layer._shard_grid(shape, n)
    ranges = sharded._shard_grid(shape, n)
    assert [fmt.num_hypercubes((r1 - r0,) + shape[1:]) for r0, r1 in ranges] == real
    owned = [(r0, r1) for r0, r1 in ranges if r0 < r1]
    assert owned[0][0] == 0 and owned[-1][1] == shape[0]
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))


def test_sharded_rejects_all_border():
    data = make_data((7, 70), np.float32, 5)  # no whole block
    with pytest.raises(ValueError, match="no whole hypercube"):
        compress_sharded(data, CPU8)
    with pytest.raises(ValueError, match="no whole hypercube"):
        compress_sharded_device(torch.from_numpy(data), CPU8)
    with pytest.raises(ValueError, match="no whole hypercube"):
        decompress_sharded(golden.compress(data)[0], (7, 70), np.float32, CPU8)


@pytest.mark.parametrize("n", [3, 5])
def test_sharded_odd_mesh_sizes(jax_sharded, n):
    shape = (4096 * 7 + 5,)  # 7 block rows over 3 or 5 shards
    data = make_data(shape, np.float32, 6)
    expect = check_stream(data, ["cpu"] * n)
    jstream, _ = jax_sharded(data)
    assert np.asarray(jstream).tobytes() == expect.tobytes()
    out = decompress_sharded(expect, shape, np.float32, ["cpu"] * n)
    assert np.array_equal(word_view(out), word_view(data))


def test_sharded_device_decode_host_stream():
    """A numpy stream takes the same device path."""
    shape = (4096 * 16 + 33,)
    data = make_data(shape, np.float32, 7)
    stream, _ = golden.compress(data)
    slabs = decompress_sharded_device(stream, shape, np.float32, CPU8)
    assert len(slabs) == 8 and all(s.dtype == torch.float32 for s in slabs)
    assert np.array_equal(torch.cat(slabs).numpy().view(np.uint32), data.view(np.uint32))


@pytest.mark.parametrize("shape,dtype", [
    ((4096 * 16 + 33,), np.float32),
    ((4096 * 7 + 17, 130), np.float32),   # uneven grid
    ((128, 64, 33), np.float64),
], ids=str)
def test_sharded_device_resident_decode(shape, dtype):
    """decompress_sharded_device: the row slabs, one a shard, each on its
    device, bit-exact against the input."""
    data = make_data(shape, dtype, 8)
    stream, _ = golden.compress(data)
    slabs = decompress_sharded_device(torch.from_numpy(stream.view(np.int32)), shape, dtype, CPU8)
    ranges = sharded._shard_grid(shape, 8)
    assert [tuple(s.shape) for s in slabs] == [(r1 - r0,) + shape[1:] for r0, r1 in ranges]
    whole = torch.cat(slabs).numpy()
    assert whole.dtype == dtype and np.array_equal(word_view(whole), word_view(data))


@pytest.mark.parametrize("shape,dtype", [
    ((4096 * 16 + 33,), np.float32),
    ((4096 * 7 + 17, 130), np.float32),   # uneven grid
    ((128, 64, 33), np.float64),
], ids=str)
def test_sharded_device_resident_encode(jax_sharded, shape, dtype):
    """compress_sharded_device: a tensor in, ``(stream, length)`` out as
    compress_device gives them: the bound's words, length in u32 words."""
    data = make_data(shape, dtype, 9)
    expect, elen = golden.compress(data)
    stream, length = compress_sharded_device(torch.from_numpy(data), CPU8)
    assert stream.dtype == torch.int32 and length.dtype == torch.int32 and length.dim() == 0
    assert stream.numel() == fmt.compressed_bound_u32(shape, data.itemsize * 8)
    length = int(length)
    assert length == expect.size == elen * (data.itemsize // 4)
    assert stream[:length].numpy().tobytes() == expect.tobytes()
    jstream, _ = jax_sharded(data)
    assert np.asarray(jstream).tobytes() == expect.tobytes()


def test_host_and_device_lengths_count_different_words():
    """The host path counts the profile's words (u64 for fp64), the device
    path u32 words, as the JAX layer's two paths do."""
    data = make_data((4096 * 3 + 1,), np.float64, 10)
    _, words = compress_sharded(data, ["cpu"] * 2)
    _, length = compress_sharded_device(torch.from_numpy(data), ["cpu"] * 2)
    assert int(length) == 2 * words == golden.compress(data)[0].size


def test_sharded_nan_inf_denormal_bit_exact(jax_sharded):
    shape = (4096 * 8 + 21,)
    data = np.full(shape, np.nan, np.float32)
    data[100:200] = np.inf
    data[300:400] = -np.inf
    data[500:600] = -0.0
    data[700:800] = np.float32(1e-42)  # denormal
    data[1000:] = np.sin(np.arange(shape[0] - 1000) * 1e-3)
    data.view(np.uint32)[900:950] = np.random.default_rng(11).integers(0, 2**32, 50, dtype=np.uint32)
    expect = check_stream(data, CPU8, jax_sharded)
    out = decompress_sharded(expect, shape, np.float32, CPU8)
    assert np.array_equal(out.view(np.uint32), data.view(np.uint32))


def test_streams_of_other_devices_and_out_device():
    """The slabs move to their shards' devices from wherever the input lies,
    and the stream is assembled where ``out_device`` says."""
    data = make_data((64 * 3, 70), np.float32, 12)
    x = torch.from_numpy(data)
    stream, length = compress_sharded_device(x, ["cpu"] * 3, out_device="cpu")
    assert stream.device.type == "cpu" and length.device.type == "cpu"
    assert stream[: int(length)].numpy().tobytes() == golden.compress(data)[0].tobytes()


def test_decode_rejects_a_short_stream():
    data = make_data((4096 * 4 + 7,), np.float32, 13)
    stream, _ = golden.compress(data)
    with pytest.raises(ValueError, match="shorter"):
        decompress_sharded(stream[:-1], data.shape, np.float32, CPU8)
    with pytest.raises(ValueError, match="header"):
        decompress_sharded(stream[:2], data.shape, np.float32, CPU8)


def test_make_mesh(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    assert make_mesh(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh([])


@pytest.mark.parametrize("n", [3, 8])
def test_dryrun_multichip_on_cpu(n):
    dryrun_multichip(n, ["cpu"])


def test_dryrun_multichip_needs_a_gpu_by_default(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(4)


def test_sharded_backend_without_a_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_compressor(np.float32, 1, "sharded")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_decompressor(np.float64, 3, "sharded")


def test_auto_never_picks_sharded(monkeypatch):
    monkeypatch.delenv(api.BACKEND_ENV, raising=False)
    for gpu in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda gpu=gpu: gpu)
        assert api._resolve_backend("auto") != "sharded"


@pytest.mark.parametrize("shape,dtype", [((4096 * 3 + 5,), np.float32), ((70, 130), np.float64),
                                         ((16 * 5, 16, 17), np.float64)], ids=str)
def test_sharded_backend_round_trip(cpu_mesh, shape, dtype):
    off = api.make_offloader("sharded", dtype, len(shape))
    data = make_data(shape, dtype, 14)
    stream, words = off.compress(data)
    expect, elen = golden.compress(data)
    assert words == elen and stream.tobytes() == expect.tobytes()
    assert np.array_equal(word_view(off.decompress(stream, shape)), word_view(data))
    assert off.timing.compress_ns > 0 and off.timing_mode == "wall"
    with pytest.raises(ValueError, match="no whole hypercube"):
        off.compress(make_data((8,) * len(shape), dtype, 15))


def test_cli_sharded_on_the_cpu_mesh(cpu_mesh, tmp_path, capsys):
    data = make_data((200, 130), np.float32, 16)
    raw, comp, back = tmp_path / "in.f32", tmp_path / "out.ndz", tmp_path / "back.f32"
    raw.write_bytes(data.tobytes())
    flags = ["-n", "200", "130", "-t", "float", "-e", "sharded"]
    assert cli.run(flags + ["-i", str(raw), "-o", str(comp)]) == 0
    assert "sharded->sharded" in capsys.readouterr().err
    assert comp.read_bytes() == golden.compress(data)[0].tobytes()
    assert cli.run(["-d"] + flags + ["-i", str(comp), "-o", str(back)]) == 0
    assert back.read_bytes() == data.tobytes()


def test_cli_sharded_without_a_gpu_fails(no_gpu, tmp_path, capsys):
    raw = tmp_path / "in.f32"
    raw.write_bytes(np.zeros(4096, np.float32).tobytes())
    assert cli.run(["-n", "4096", "-e", "sharded", "-i", str(raw), "-o", str(tmp_path / "o.ndz")]) == 1
    assert "CUDA" in capsys.readouterr().err


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SHAPES + UNEVEN, ids=str)
def test_cuda_sharded_stream_and_round_trip(cuda, shape, dtype):
    data = make_data(shape, dtype, 17)
    expect = check_stream(data, cuda)
    out = decompress_sharded(expect, shape, dtype, cuda)
    assert np.array_equal(word_view(out), word_view(data))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", PAD64, ids=str)
def test_cuda_sharded_fp64_pad_entries(cuda, shape, n):
    mesh = ["cuda"] * n
    data = make_data(shape, np.float64, 4)
    expect = check_stream(data, mesh)
    assert np.array_equal(word_view(decompress_sharded(expect, shape, np.float64, mesh)), word_view(data))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", SHAPES + UNEVEN, ids=str)
def test_cuda_sharded_device_resident(cuda, shape, dtype):
    data = make_data(shape, dtype, 18)
    expect, _ = golden.compress(data)
    x = torch.from_numpy(data).to("cuda")
    stream, length = compress_sharded_device(x, cuda)
    assert stream.is_cuda and length.is_cuda
    length = int(length)
    assert stream[:length].cpu().numpy().tobytes() == expect.tobytes()
    slabs = decompress_sharded_device(stream[:length], shape, dtype, cuda)
    assert all(s.is_cuda for s in slabs) and torch.equal(torch.cat(slabs).view(torch.uint8), x.view(torch.uint8))


@pytest.mark.cuda
def test_cuda_dryrun_multichip(cuda):
    dryrun_multichip(4)
