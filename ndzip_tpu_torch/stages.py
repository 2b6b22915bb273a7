"""Stage kernels of the CUDA codec, each a part of B1/B3/B4 alone, with
their plain PyTorch versions: what ``ubench`` times next to the codec's
kernels.

The counterparts of the JAX package's three probe kernels in ``dev/``:

* ``placement_floor``/``placement_compute`` (``csrc/stage_placement.cu``)
  for ``dev/enc_floor_probe.py:100``: B1's placement pass with its compute
  taken out, and with its compaction taken out (the block's dense row);
* ``keep_mask`` (``csrc/stage_keep_mask.cu``) for ``dev/mosaic_repro.py:39``:
  the select of B1's compaction over its staging rows;
* ``gather_blocks_nd``/``scatter_blocks_nd`` (``csrc/stage_blocks_nd.cu``)
  for ``dev/tile_xpose_probe.py:67``: B3/B4's (and B6/B8's) strided block
  load and store between a 2D/3D grid and dense blocks, for int32 and int64
  words. Their plain versions are ``codec_torch.gather_blocks``/
  ``scatter_blocks``.

As in ``codec_cuda``, a wrapper takes only CUDA tensors, launches on the
current stream and raises on a failed build or launch; nothing falls back
to a plain version. ``LAUNCHES`` counts each wrapper's launches. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import torch

from . import _build
from . import format as fmt
from .codec_cuda import _check_cuda_words, _extents, _launch
from .codec_torch import HC, encode_blocks_dense

#: launches of each stage kernel wrapper since the count was last set to 0
LAUNCHES = {"placement_floor": 0, "placement_compute": 0, "keep_mask": 0,
            "gather_blocks_nd": 0, "scatter_blocks_nd": 0,
            "gather_blocks_nd64": 0, "scatter_blocks_nd64": 0}

HEADS = HC // 32             # head words of an fp32 block
DENSE = HEADS + HC           # words of an fp32 block's dense row: 4224
FLOOR = 2 * DENSE // 3       # words placement_floor writes per block: 2816
LANES = 128                  # words per row of the staging layout
ROWS = DENSE // LANES        # rows of a block's dense row: 33
P2_ROWS, P2_LIMIT = 265, 200  # dev/mosaic_repro.py's shape and row limit


# ------------------------------------------------------------ plain versions


def placement_floor_ref(blocks: torch.Tensor) -> torch.Tensor:
    """(nb, 4096) int32 blocks -> (nb, 2816): block b's first 2816 words of
    ``[blocks[b, :128] ^ b, blocks[b]]``."""
    step = torch.arange(blocks.shape[0], dtype=blocks.dtype, device=blocks.device)[:, None]
    return torch.cat([blocks[:, :HEADS] ^ step, blocks], dim=1)[:, :FLOOR]


def placement_compute_ref(blocks: torch.Tensor) -> torch.Tensor:
    """(nb, 4096) int32 blocks -> (nb, 4224): each block's dense row, its
    128 heads then its 4096 bit-transposed words of the 1D transform, zeros
    kept (``codec_torch.encode_blocks_dense(blocks, 1)[0]``)."""
    return encode_blocks_dense(blocks, 1)[0]


def keep_mask_ref(x: torch.Tensor, limit: int = P2_LIMIT) -> torch.Tensor:
    """The keep mask of an (R, 128) int32 staging layout, as int32 (the
    int form of ``dev/mosaic_repro.py``'s select, ``kern_int_where``). With
    ``fill = x[0, 0]``: row 0 keeps its first ``fill`` words; row r >= 1
    keeps a word where ``r % 33 == 1`` (a block's heads) or the word is
    nonzero, and only while ``r < limit``.

    On ``staging(dense, fill)`` of nb blocks' dense rows with ``limit = 1 +
    33 * nb``, rows ``1 .. 33 * nb`` are ``encode_blocks_dense``'s
    ``valid``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    body = ((rows % ROWS == 1) | (x != 0)) & (rows < limit)
    return torch.where(rows == 0, (cols < x[0, 0]).to(torch.int32), body.to(torch.int32))


def staging(dense: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """``[fill row ; dense rows]`` as (1 + 33 nb, 128) int32: a row of zeros
    whose first word is ``fill``, then the (nb, 4224) dense rows."""
    head = torch.zeros((1, LANES), dtype=torch.int32, device=dense.device)
    head[0, 0] = fill
    return torch.cat([head, dense.reshape(-1, LANES)])


# ------------------------------------------------------------ kernels


def _check_blocks(blocks: torch.Tensor, dtype=torch.int32):
    _check_cuda_words("blocks", blocks, dims=(2,), dtype=dtype)
    if blocks.shape[0] == 0 or blocks.shape[1] != HC:
        raise ValueError(f"blocks must be (nb >= 1, {HC}), got {tuple(blocks.shape)}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")


def placement_floor(blocks: torch.Tensor) -> torch.Tensor:
    """``placement_floor_ref`` on the card (``csrc/stage_placement.cu``)."""
    _check_blocks(blocks)
    lib = _build.load()
    out = torch.empty((blocks.shape[0], FLOOR), dtype=torch.int32, device=blocks.device)
    _launch(lib.ndzip_placement_floor, blocks.get_device(), blocks.data_ptr(), blocks.shape[0],
            out.data_ptr())
    LAUNCHES["placement_floor"] += 1
    return out


def placement_compute(blocks: torch.Tensor) -> torch.Tensor:
    """``placement_compute_ref`` on the card (``csrc/stage_placement.cu``)."""
    _check_blocks(blocks)
    lib = _build.load()
    out = torch.empty((blocks.shape[0], DENSE), dtype=torch.int32, device=blocks.device)
    _launch(lib.ndzip_placement_compute, blocks.get_device(), blocks.data_ptr(), blocks.shape[0],
            out.data_ptr())
    LAUNCHES["placement_compute"] += 1
    return out


def keep_mask(x: torch.Tensor, limit: int = P2_LIMIT) -> torch.Tensor:
    """``keep_mask_ref`` on the card (``csrc/stage_keep_mask.cu``): x is
    (R >= 1, 128) int32."""
    _check_cuda_words("x", x, dims=(2,))
    if x.shape[0] == 0 or x.shape[1] != LANES:
        raise ValueError(f"x must be (R >= 1, {LANES}), got {tuple(x.shape)}")
    lib = _build.load()
    out = torch.empty_like(x)
    _launch(lib.ndzip_keep_mask, x.get_device(), x.data_ptr(), x.shape[0], int(limit), out.data_ptr())
    LAUNCHES["keep_mask"] += 1
    return out


def _grid_words(name: str, words: torch.Tensor) -> int:
    """Check a 2D/3D CUDA grid of int32/int64 words; return its block count."""
    if words.is_cuda and words.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be int32 or int64 words, got {words.dtype}")
    _check_cuda_words(name, words, dims=(2, 3), dtype=words.dtype)
    num_hc = fmt.num_hypercubes(tuple(words.shape))
    if num_hc == 0:
        raise ValueError(f"shape {tuple(words.shape)} has no whole block: it is all border")
    return num_hc


def _key(name: str, words: torch.Tensor) -> str:
    return name + ("64" if words.dtype == torch.int64 else "")


def gather_blocks_nd(words: torch.Tensor) -> torch.Tensor:
    """``codec_torch.gather_blocks`` on the card (``csrc/stage_blocks_nd.cu``):
    the whole blocks of a 2D/3D int32/int64 grid as (num_hc, 4096) words in
    the header's order, row-major inside each block."""
    num_hc = _grid_words("words", words)
    lib = _build.load()
    out = torch.empty((num_hc, HC), dtype=words.dtype, device=words.device)
    _launch(lib.ndzip_gather_blocks_nd, words.get_device(), words.data_ptr(), words.element_size(),
            words.dim(), *_extents(words.shape), out.data_ptr())
    LAUNCHES[_key("gather_blocks_nd", words)] += 1
    return out


def scatter_blocks_nd(blocks: torch.Tensor, out: torch.Tensor) -> None:
    """``codec_torch.scatter_blocks`` on the card: write (num_hc, 4096)
    blocks into the whole blocks of the 2D/3D grid ``out`` in place; words
    outside whole blocks are left as they are."""
    num_hc = _grid_words("out", out)
    _check_cuda_words("blocks", blocks, dims=(2,), dtype=out.dtype)
    if tuple(blocks.shape) != (num_hc, HC):
        raise ValueError(f"blocks must be ({num_hc}, {HC}) for a grid of shape {tuple(out.shape)}, "
                         f"got {tuple(blocks.shape)}")
    lib = _build.load()
    _launch(lib.ndzip_scatter_blocks_nd, out.get_device(), blocks.data_ptr(), out.element_size(), out.dim(),
            *_extents(out.shape), out.data_ptr())
    LAUNCHES[_key("scatter_blocks_nd", out)] += 1
