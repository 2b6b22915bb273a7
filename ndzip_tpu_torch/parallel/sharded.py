"""Block-parallel compress and decompress over a list of devices: the
counterpart of ``ndzip_tpu/parallel/sharded.py``.

Blocks are independent, so the grid is cut into full-width row slabs along
axis 0, one a shard, each compressed by the device's own codec
(``compress_device``: the kernels of ``codec_cuda`` on a CUDA device, the
plain versions of ``codec_torch`` on the CPU). The streams are those of the
JAX layer, byte for byte, and so those of every single-device backend:

* Shard k owns the block rows ``[k * rows_pb, min(grid0, (k + 1) * rows_pb))``,
  ``rows_pb = ceil(grid0 / n)``; the last shard that owns blocks also owns
  the rows past the block grid (the axis-0 border), and a shard with no
  block row owns nothing (``_shard_grid``). The JAX layer pads trailing
  shards with zero blocks because ``shard_map`` needs equal local shapes;
  here no shard is padded.
* A slab's stream is ``header | body | border``. ``format.border_slices``
  enumerates border runs in memory order, so the slabs' borders in shard
  order are the grid's border.
* Assembly: every shard's encode is queued first, then the n lengths come to
  the host in one synchronisation, then each shard's spans are copied into
  one stream: its header entries rebased by the body words of the shards
  before (entries are offsets after each block in the profile's words, u64
  words for fp64), its body, its border. The global header has one zero pad
  entry where the global block count is odd (fp64); the shards' own pads
  are dropped.
* Decode reads the global header once and gives each shard a sub-stream of
  its own: its entries rebased to zero, its body span, its border span.

A mesh is a tuple of ``torch.device`` (``make_mesh``). A device may appear
more than once, so one card can hold several shards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import codec_torch, compress_device, decompress_device, interop
from .. import format as fmt


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """The devices that the shards run on, in shard order: by default every
    visible CUDA device, else ``devices`` (names or ``torch.device``; a device
    may appear more than once). Without a CUDA device the default raises
    RuntimeError: shards run on the CPU only when the caller asks for it, as
    ``["cpu"] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a CUDA device: torch.cuda.is_available() is false "
                               "(pass devices=['cpu'] * n for shards on the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _shard_grid(shape, n_shards: int) -> list[tuple[int, int]]:
    """The row range ``(r0, r1)`` of the slab ``x[r0:r1]`` that each of
    ``n_shards`` shards owns (see the module's docstring); ``r0 == r1`` for a
    shard with no block row. Raises ValueError for a grid with no whole
    block: all-border grids take a single-device codec."""
    shape = tuple(shape)
    fmt.validate_shape(shape)
    if fmt.num_hypercubes(shape) == 0:
        raise ValueError(f"shape {shape} has no whole hypercube blocks to shard; all-border grids must use a "
                         "single-device codec")
    side = fmt.SIDE_LENGTH[len(shape)]
    grid0 = shape[0] // side
    rows_pb = -(-grid0 // n_shards)
    owners = -(-grid0 // rows_pb)  # shards that own block rows
    ranges = []
    for k in range(n_shards):
        if k >= owners:
            ranges.append((shape[0], shape[0]))
        else:
            ranges.append((k * rows_pb * side, shape[0] if k == owners - 1 else (k + 1) * rows_pb * side))
    return ranges


@dataclass
class _Shard:
    """One slab's stream as ``compress_device`` gave it, and its spans in u32 words."""

    stream: torch.Tensor
    num_hc: int
    header_u32: int
    body_u32: int
    border_u32: int

    def header(self) -> torch.Tensor:
        return self.stream[: self.num_hc]  # without the fp64 pad entry

    def body(self) -> torch.Tensor:
        return self.stream[self.header_u32: self.header_u32 + self.body_u32]

    def border(self) -> torch.Tensor:
        start = self.header_u32 + self.body_u32
        return self.stream[start: start + self.border_u32]


def _encode_shards(x: torch.Tensor, mesh) -> tuple[list[_Shard], int]:
    """Compress each non-empty slab of ``x`` on its shard's device, all
    queued before one synchronisation that brings the lengths to the host.
    Returns the shards in order and the word width."""
    words = codec_torch.as_words(x)
    shape, wb = tuple(words.shape), words.element_size() * 8
    queued = []
    for dev, (r0, r1) in zip(mesh, _shard_grid(shape, len(mesh))):
        if r0 < r1:
            slab = words[r0:r1].to(dev, non_blocking=True)
            queued.append((tuple(slab.shape), *compress_device(slab)))
    lengths = torch.stack([length.to(mesh[0], non_blocking=True) for _, _, length in queued]).tolist()
    shards = []
    for (slab_shape, stream, _), length in zip(queued, lengths):
        num_hc = fmt.num_hypercubes(slab_shape)
        header_u32 = fmt.header_u32_words(num_hc, wb)
        border_u32 = fmt.border_element_count(slab_shape) * (wb // 32)
        shards.append(_Shard(stream, num_hc, header_u32, length - header_u32 - border_u32, border_u32))
    return shards, wb


def compress_sharded_device(x: torch.Tensor, mesh, out_device=None):
    """Compress a float32/float64 (or int32/int64 word) tensor of 1-3 dims,
    lying on any device, block-parallel over ``mesh``: each row slab is moved
    to its shard's device and compressed there, and the stream is assembled
    on ``out_device`` (default: the mesh's first device).

    Returns ``(stream, length)`` as ``compress_device`` does: an int32 stream
    of ``format.compressed_bound_u32(shape, W)`` words, whose words past
    ``length`` are undefined, and ``length`` in **u32 words** as an int32
    scalar on ``out_device``. ``stream[:length]`` is byte for byte the stream
    of every single-device backend."""
    mesh = make_mesh(mesh)
    out_device = mesh[0] if out_device is None else torch.device(out_device)
    shards, wb = _encode_shards(x, mesh)
    shape, wu = tuple(x.shape), wb // 32
    num_hc = fmt.num_hypercubes(shape)
    header_u32 = fmt.header_u32_words(num_hc, wb)
    stream = torch.empty(fmt.compressed_bound_u32(shape, wb), dtype=torch.int32, device=out_device)
    stream[num_hc:header_u32] = 0  # the fp64 pad entry of an odd block count
    entry, body_at = 0, header_u32
    border_at = header_u32 + sum(s.body_u32 for s in shards)
    for s in shards:
        head = stream[entry: entry + s.num_hc]
        head.copy_(s.header(), non_blocking=True)
        if body_at > header_u32:
            head += (body_at - header_u32) // wu
        stream[body_at: body_at + s.body_u32].copy_(s.body(), non_blocking=True)
        stream[border_at: border_at + s.border_u32].copy_(s.border(), non_blocking=True)
        entry, body_at, border_at = entry + s.num_hc, body_at + s.body_u32, border_at + s.border_u32
    return stream, torch.full((), border_at, dtype=torch.int32, device=out_device)


def compress_sharded(data: np.ndarray, mesh) -> tuple[np.ndarray, int]:
    """Compress a float32/float64 numpy array of 1-3 dims block-parallel over
    ``mesh``; returns ``(uint32 stream, length in the profile's words)``, as
    ``ndzip_tpu.parallel.compress_sharded`` does (the device path's length
    counts u32 words)."""
    data = np.ascontiguousarray(data)
    stream, length = compress_sharded_device(interop.words_from_numpy(data), mesh)
    length = int(length)
    return interop.stream_to_numpy(stream, length), length // (data.itemsize // 4)


def decompress_sharded_device(stream, shape, dtype, mesh) -> list[torch.Tensor]:
    """Decompress an int32 stream tensor (on any device) or a uint32 numpy
    stream block-parallel over ``mesh``. Returns the row slabs of the grid,
    one a shard, each on its shard's device (a shard with no block row gives
    an empty slab): the counterpart of the mesh-sharded array that
    ``ndzip_tpu.parallel.decompress_sharded_device`` returns. The whole grid
    is ``torch.cat([s.to(device) for s in slabs])``.

    The header is read to the host once; each shard's sub-stream (its header
    entries rebased to zero, its body span, its border span) is copied to its
    device and decoded there, all of them queued without a synchronisation."""
    mesh = make_mesh(mesh)
    shape = tuple(shape)
    out_dtype = codec_torch.output_dtype(shape, dtype)
    wb = out_dtype.itemsize * 8
    wu = wb // 32
    ranges = _shard_grid(shape, len(mesh))
    if isinstance(stream, np.ndarray):
        stream = interop.stream_from_numpy(stream)
    if stream.dtype != torch.int32 or stream.dim() != 1:
        raise ValueError(f"expected a 1D int32 stream, got {stream.dtype} of shape {tuple(stream.shape)}")
    num_hc = fmt.num_hypercubes(shape)
    header_u32 = fmt.header_u32_words(num_hc, wb)
    if stream.numel() < header_u32:
        raise ValueError(f"stream of {stream.numel()} words cannot hold a {num_hc}-entry header")
    offsets = stream[:num_hc].cpu().numpy().astype(np.int64)
    border_at = header_u32 + int(offsets[-1]) * wu
    need = border_at + fmt.border_element_count(shape) * wu
    if stream.numel() < need:
        raise ValueError(f"stream of {stream.numel()} words is shorter than the {need} its header implies")
    slabs, entry = [], 0
    for dev, (r0, r1) in zip(mesh, ranges):
        slab_shape = (r1 - r0,) + shape[1:]
        if r0 == r1:
            slabs.append(torch.empty(slab_shape, dtype=out_dtype, device=dev))
            continue
        n = fmt.num_hypercubes(slab_shape)
        head = fmt.header_u32_words(n, wb)
        base = int(offsets[entry - 1]) if entry else 0
        body = (int(offsets[entry + n - 1]) - base) * wu
        border = fmt.border_element_count(slab_shape) * wu
        sub = torch.empty(head + body + border, dtype=torch.int32, device=dev)
        sub[:n].copy_(stream[entry: entry + n], non_blocking=True)
        if base:
            sub[:n] -= base
        sub[n:head] = 0
        body_at = header_u32 + base * wu
        sub[head: head + body].copy_(stream[body_at: body_at + body], non_blocking=True)
        sub[head + body:].copy_(stream[border_at: border_at + border], non_blocking=True)
        slabs.append(decompress_device(sub, slab_shape, out_dtype))
        entry, border_at = entry + n, border_at + border
    return slabs


def decompress_sharded(stream, shape, dtype, mesh) -> np.ndarray:
    """Decompress a uint32 numpy stream block-parallel over ``mesh`` into a
    numpy array of ``shape`` and ``dtype``."""
    slabs = decompress_sharded_device(np.asarray(stream, dtype=np.uint32), shape, dtype, mesh)
    return np.concatenate([interop.words_to_numpy(s, dtype) for s in slabs]).reshape(tuple(shape))
