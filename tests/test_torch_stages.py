"""The stage kernels of ``ndzip_tpu_torch.stages`` and the plain versions
they are held to.

On the CPU, exact bits: the plain block gather and scatter (the P3 stage,
``codec_torch.gather_blocks``/``scatter_blocks``) against the JAX package's
tile adapters and their XOR cell-swap twins, each run inside a Pallas call
in interpret mode built as ``dev/tile_xpose_probe.py`` builds it, and
against ``codec_xla``'s gather and scatter on bordered grids; the plain keep
mask (P2) against ``dev/mosaic_repro.py``'s ``kern_int_where`` in interpret
mode and against ``golden.encode_blocks_dense``'s ``valid``; the plain
placement stages (P1) against ``golden.encode_blocks_dense`` and the floor's
definition (the probe's own output overlaps by design and is no
reference); ``codec_torch.encode_blocks_dense`` against golden. On a card
(marker ``cuda``, skipped elsewhere): each stage kernel against its plain
version on chip_smoke.py's phase-3 cases and on ubench's 64 MiB working
sets, exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import fp64_kernel_cases, kernel_cases, nd_kernel_cases  # noqa: E402
from ndzip_tpu import format as fmt  # noqa: E402
from ndzip_tpu import golden  # noqa: E402
from ndzip_tpu_torch import codec_torch, stages  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HC = codec_torch.HC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def as_int(words: np.ndarray) -> torch.Tensor:
    """uint32/uint64 words -> the port's int32/int64 tensor with the same bits."""
    words = np.ascontiguousarray(words)
    return torch.from_numpy(words.view(np.int32 if words.itemsize == 4 else np.int64))


def random_words(shape, bits=32, seed=0):
    t = np.uint32 if bits == 32 else np.uint64
    return np.random.default_rng(seed).integers(0, 2**bits, shape, dtype=np.uint64).astype(t)


def probe_call(fn, in_shape, out_shape, x, G):
    """``fn(x, G)`` inside a Pallas call in interpret mode, as
    ``dev/tile_xpose_probe.py:58-74`` builds it, for one grid step."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[:] = fn(x_ref[:].reshape(in_shape), G).reshape(o_ref.shape)

    flat_in = (1, int(np.prod(in_shape[:-1])), in_shape[-1])
    flat_out = (1, int(np.prod(out_shape[:-1])), out_shape[-1])
    out = pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec((1,) + flat_in[1:], lambda g: (g, 0, 0))],
        out_specs=pl.BlockSpec((1,) + flat_out[1:], lambda g: (g, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(flat_out, jnp.uint32),
        interpret=True,
    )(jnp.asarray(x.reshape(flat_in)))
    return np.asarray(out).reshape(out_shape)


# ------------------------------------------------------------ P3: block gather and scatter


@pytest.mark.parametrize("variant", ["", "_bfly"], ids=["gather", "bfly"])
@pytest.mark.parametrize("dims", [2, 3])
def test_block_moves_match_tile_adapters(dims, variant):
    """A strip of G blocks, (64, 128) at G = 2 or (16, 16, 128) at G = 8:
    the plain gather equals tile_to_blocks, the plain scatter blocks_to_tile."""
    from ndzip_tpu import codec_pallas

    G = 2 if dims == 2 else 8
    strip = (64, G * 64) if dims == 2 else (16, 16, G * 16)
    flat = (G, 32, 128)
    tile = random_words(strip, seed=dims)
    t2b = getattr(codec_pallas, f"tile_to_blocks_{dims}d{variant}")
    b2t = getattr(codec_pallas, f"blocks_to_tile_{dims}d{variant}")

    ours = codec_torch.gather_blocks(as_int(tile), strip).numpy().view(np.uint32)
    assert np.array_equal(ours.reshape(flat), probe_call(t2b, strip, flat, tile, G))

    blocks = random_words((G, HC), seed=10 + dims)
    out = torch.zeros(strip, dtype=torch.int32)
    codec_torch.scatter_blocks(as_int(blocks), strip, out)
    assert np.array_equal(out.numpy().view(np.uint32), probe_call(b2t, flat, strip, blocks, G))


@pytest.mark.parametrize("shape", [(130, 513), (64, 200), (17, 32, 129), (33, 33, 32)], ids=str)
def test_block_moves_match_xla_on_bordered_grids(shape):
    import jax.numpy as jnp

    from ndzip_tpu import codec_xla

    words = random_words(shape, seed=len(shape))
    blocks = codec_torch.gather_blocks(as_int(words), shape)
    theirs = np.asarray(codec_xla._gather_blocks(jnp.asarray(words), shape))
    assert np.array_equal(blocks.numpy().view(np.uint32), theirs)

    new = random_words(theirs.shape, seed=7)
    base = random_words(shape, seed=8)
    out = as_int(base).clone()
    codec_torch.scatter_blocks(as_int(new), shape, out)
    expect = codec_xla._scatter_blocks(jnp.asarray(new), shape, jnp.asarray(base.reshape(-1)))
    assert np.array_equal(out.numpy().view(np.uint32).reshape(-1), np.asarray(expect))


# ------------------------------------------------------------ P2: keep mask


def mosaic_repro():
    """dev/mosaic_repro.py, loaded from its path (it is not a package)."""
    spec = importlib.util.spec_from_file_location("mosaic_repro", ROOT / "dev" / "mosaic_repro.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", ["ones", "random fill 0", "random fill 37", "random fill 128"])
def test_keep_mask_ref_matches_mosaic_repro(case):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    m = mosaic_repro()
    assert (m.R, m.LANES) == (stages.P2_ROWS, stages.LANES)
    if case == "ones":
        x = np.ones((m.R, m.LANES), np.uint32)
    else:
        rng = np.random.default_rng(int(case.split()[-1]))
        x = random_words((m.R, m.LANES), seed=3)
        x[rng.random(x.shape) < 0.5] = 0
        x[0, 0] = int(case.split()[-1])
    theirs = pl.pallas_call(m.kern_int_where, out_shape=jax.ShapeDtypeStruct((m.R, m.LANES), jnp.int32),
                            interpret=True)(jnp.asarray(x))
    ours = stages.keep_mask_ref(as_int(x), stages.P2_LIMIT)
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_keep_mask_ref_rows_are_golden_valid():
    nb = 3
    blocks = random_words((nb, HC), seed=5)
    blocks[0] = 0
    blocks[1, ::3] = 0
    dense, valid, _ = golden.encode_blocks_dense(blocks, 1)
    x = stages.staging(as_int(dense), fill=5)
    assert x.shape == (1 + stages.ROWS * nb, stages.LANES)
    mask = stages.keep_mask_ref(x, 1 + stages.ROWS * nb)
    assert np.array_equal(mask[1:].numpy().reshape(nb, stages.DENSE).astype(bool), valid)
    assert mask[0].tolist() == [1] * 5 + [0] * (stages.LANES - 5)


# ------------------------------------------------------------ P1: placement stages


def test_placement_compute_ref_is_golden_dense():
    blocks = kernel_cases()["4096*8"].view(np.uint32).reshape(-1, HC)
    ours = stages.placement_compute_ref(as_int(blocks))
    assert ours.shape == (blocks.shape[0], stages.DENSE)
    assert np.array_equal(ours.numpy().view(np.uint32), golden.encode_blocks_dense(blocks, 1)[0])


def test_placement_floor_ref_follows_its_definition():
    nb = 5
    blocks = random_words((nb, HC), seed=6)
    ours = stages.placement_floor_ref(as_int(blocks)).numpy().view(np.uint32)
    assert stages.FLOOR == 2816
    expect = np.concatenate([blocks[:, :128] ^ np.arange(nb, dtype=np.uint32)[:, None], blocks], axis=1)
    assert np.array_equal(ours, expect[:, :2816])


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("bits", [32, 64])
def test_encode_blocks_dense_matches_golden(bits, dims):
    blocks = random_words((4, HC), bits, seed=bits + dims)
    blocks[0] = 0
    blocks[1] = blocks[1, 0]  # a constant block
    blocks[2, 64:200] = 0
    dense, valid, lengths = codec_torch.encode_blocks_dense(as_int(blocks), dims)
    g_dense, g_valid, g_lengths = golden.encode_blocks_dense(blocks, dims)
    assert np.array_equal(dense.numpy().view(blocks.dtype), g_dense)
    assert np.array_equal(valid.numpy(), g_valid)
    assert np.array_equal(lengths.numpy(), g_lengths)


# ------------------------------------------------------------ the kernels on a card


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(kernel_cases()))
def test_cuda_placement_stages_match_plain(cuda, label):
    w = torch.from_numpy(kernel_cases()[label].view(np.int32)).to(cuda)
    blocks = w[: w.numel() // HC * HC].reshape(-1, HC)
    assert torch.equal(stages.placement_floor(blocks), stages.placement_floor_ref(blocks))
    assert torch.equal(stages.placement_compute(blocks), stages.placement_compute_ref(blocks))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0, 37, 128])
def test_cuda_keep_mask_matches_plain(cuda, fill):
    x = np.random.default_rng(fill).integers(-2**31, 2**31, (stages.P2_ROWS, stages.LANES)).astype(np.int32)
    x[x % 2 == 0] = 0
    x[0, 0] = fill
    xt = torch.from_numpy(x).to(cuda)
    assert torch.equal(stages.keep_mask(xt), stages.keep_mask_ref(xt))
    ones = torch.ones((stages.P2_ROWS, stages.LANES), dtype=torch.int32, device=cuda)
    assert torch.equal(stages.keep_mask(ones), stages.keep_mask_ref(ones))
    blocks = torch.from_numpy(kernel_cases()["4096*8"].view(np.int32)).to(cuda).reshape(-1, HC)
    staged, limit = stages.staging(stages.placement_compute_ref(blocks), fill), 1 + stages.ROWS * 8
    assert torch.equal(stages.keep_mask(staged, limit), stages.keep_mask_ref(staged, limit))


#: chip_smoke.py's 2D/3D cases of both dtypes that hold a whole block
GRIDS = {label: data for label, data in list(nd_kernel_cases().items())
         + [(f"fp64 {k}", v) for k, v in fp64_kernel_cases().items()]
         if data.ndim > 1 and fmt.num_hypercubes(data.shape)}


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(GRIDS))
def test_cuda_block_moves_match_plain(cuda, label):
    data = GRIDS[label]
    w = as_int(data.view(np.uint32 if data.itemsize == 4 else np.uint64)).to(cuda)
    blocks = codec_torch.gather_blocks(w, w.shape)
    assert torch.equal(stages.gather_blocks_nd(w), blocks)
    out, ref = torch.full_like(w, -1), torch.full_like(w, -1)
    stages.scatter_blocks_nd(blocks, out)
    codec_torch.scatter_blocks(blocks, w.shape, ref)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype", [(1, "float"), (2, "float"), (3, "float"), (3, "double")])
def test_cuda_stages_match_plain_at_ubench_sizes(cuda, dims, dtype):
    """ubench's 64 MiB working sets, where the grids run many waves of CTAs
    and the keep mask's grid-stride loop goes round more than once."""
    from ndzip_tpu_torch import interop, ubench

    shape = ubench.working_shape(64, dims, dtype)
    w = interop.words_from_numpy(ubench.stage_data(shape, dtype), cuda)
    if dims == 1:
        blocks = w.reshape(-1, HC)
        assert torch.equal(stages.placement_floor(blocks), stages.placement_floor_ref(blocks))
        dense = stages.placement_compute(blocks)
        assert torch.equal(dense, stages.placement_compute_ref(blocks))
        staged, limit = stages.staging(dense, 37), 1 + stages.ROWS * blocks.shape[0]
        assert torch.equal(stages.keep_mask(staged, limit), stages.keep_mask_ref(staged, limit))
        return
    blocks = codec_torch.gather_blocks(w, shape)
    assert torch.equal(stages.gather_blocks_nd(w), blocks)
    out, ref = torch.full_like(w, -1), torch.full_like(w, -1)
    stages.scatter_blocks_nd(blocks, out)
    codec_torch.scatter_blocks(blocks, shape, ref)
    assert torch.equal(out, ref)
