"""Multi-process block-parallel compression over ``torch.distributed``: the
counterpart of ``ndzip_tpu/parallel/multihost.py``.

* Every process owns a contiguous slab of the global grid along axis 0, all
  slabs of one shape whose axis 0 is a multiple of the block side (the usual
  HPC row decomposition), so the stream's block order is process order.
* Each process compresses its slab over its own devices
  (``sharded._encode_shards``: one row slab a device); the slab lives on
  ``cuda:<rank % device_count>`` by default, or where the caller's
  ``devices`` say (``["cpu"]`` for the plain versions).
* The only exchange is a few int64 words a process: its body length (and its
  slab's shape, which must agree). An exclusive scan of the lengths gives
  each process's body offset, and each process rebases its header entries.
* Every process then knows the absolute ranges of its header entries, body
  span and border span, so it writes them into a shared file in place
  (``ShardStream.write_to_file``, ``compress_to_file``) or sends them to
  process 0 (``gather_stream``). The result is byte for byte the serial
  stream. A slab's axis 0 is whole blocks, so the global border runs
  (``format.border_slices``) are process-contiguous: each process's border
  is one span, at ``sum(border of earlier slabs)``.

The collectives carry CPU tensors over a gloo group: gloo has no all-gather
of CUDA tensors, and NCCL refuses two ranks on one card, so this runs on one
card and on many. Where the default group is not gloo, a gloo group of all
ranks is made for them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import codec_torch, interop
from .. import format as fmt
from . import sharded

#: the gloo group of all ranks, made once where the default group's backend is not gloo
_GLOO: dict = {}


def init(master_addr: str, num_processes: int, process_id: int, backend: str = "gloo"):
    """Join the default process group at ``tcp://<master_addr>`` (``host:port``)
    as rank ``process_id`` of ``num_processes``. Collective."""
    dist.init_process_group(backend, init_method=f"tcp://{master_addr}", world_size=num_processes,
                            rank=process_id)
    _group()


def _group():
    """The group the collectives run in: the default one where it is gloo,
    else a gloo group of all ranks (made collectively on first use)."""
    if dist.get_backend() == "gloo":
        return None
    if "group" not in _GLOO:
        _GLOO["group"] = dist.new_group(backend="gloo")
    return _GLOO["group"]


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_group())
    return out


def _local_mesh(devices):
    """This process's devices: ``devices``, or the card ``rank % device_count``."""
    if devices is not None:
        return sharded.make_mesh(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("multihost needs a CUDA device by default: torch.cuda.is_available() is false "
                           "(pass devices=['cpu'] for the plain versions)")
    return (torch.device("cuda", dist.get_rank() % torch.cuda.device_count()),)


@dataclass
class ShardStream:
    """One process's slice of the global compressed stream, plus the
    placement metadata to assemble the byte-exact whole."""

    process_id: int
    num_processes: int
    header_entries: np.ndarray   # uint32, rebased to global body offsets
    entry_offset: int            # index of this process's first header entry
    num_hc_global: int
    header_u32: int              # global header length in u32 words
    body_u32: np.ndarray         # this process's body words (u32 units)
    body_offset_u32: int         # u32 offset of the body span (incl. header)
    border_u32: np.ndarray       # this process's border words (u32 units)
    border_offset_u32: int       # u32 offset of the border span
    total_u32: int               # total global stream length in u32 words

    def write_to_file(self, path: str):
        """Write this process's spans at their absolute offsets. Process 0
        has made the file ``4 * total_u32`` bytes long first
        (``compress_to_file``)."""
        with open(path, "r+b") as f:
            f.seek(4 * self.entry_offset)
            f.write(self.header_entries.tobytes())
            f.seek(4 * self.body_offset_u32)
            f.write(self.body_u32.tobytes())
            f.seek(4 * self.border_offset_u32)
            f.write(self.border_u32.tobytes())


def _host_u32(parts) -> np.ndarray:
    if not parts:
        return np.zeros(0, np.uint32)
    return torch.cat([p.cpu() for p in parts]).numpy().view(np.uint32)


def compress_multihost(local_slab, devices=None) -> ShardStream:
    """Compress a globally row-partitioned grid: every process passes its own
    slab (a numpy array or a tensor; equal shapes, axis 0 a multiple of the
    block side). Returns this process's ShardStream. Collective."""
    words = local_slab if isinstance(local_slab, torch.Tensor) else interop.words_from_numpy(local_slab)
    words = codec_torch.as_words(words)
    mesh = _local_mesh(devices)
    pid, nproc = dist.get_rank(), dist.get_world_size()
    local_shape = tuple(words.shape)
    dims = len(local_shape)
    side = fmt.SIDE_LENGTH[dims]
    global_shape = (local_shape[0] * nproc,) + local_shape[1:]
    if local_shape[0] % side:
        raise ValueError(f"local slab axis 0 ({local_shape[0]}) must be a multiple of the block side length "
                         f"{side} so processes own whole block rows")
    if fmt.num_hypercubes(global_shape) == 0:
        raise ValueError(f"global shape {global_shape} has no whole hypercube blocks (every axis must reach the "
                         f"side length {side}); all-border grids must use a single-device codec "
                         "(api.make_compressor)")
    shards, wb = sharded._encode_shards(words, mesh)
    wu = wb // 32
    body_local = sum(s.body_u32 for s in shards)
    mine = [body_local, wb] + [1] * (3 - dims) + list(local_shape)
    gathered = [g.tolist() for g in _all_gather(torch.tensor(mine, dtype=torch.int64))]
    if any(g[1:] != mine[1:] for g in gathered):
        raise ValueError(f"every process must pass a slab of one shape and dtype; (bits, extents) per process: "
                         f"{[g[1:] for g in gathered]}")
    bodies = [g[0] for g in gathered]
    body_before, body_total = sum(bodies[:pid]), sum(bodies)

    num_hc_local = fmt.num_hypercubes(local_shape)
    num_hc = num_hc_local * nproc
    header_u32 = fmt.header_u32_words(num_hc, wb)
    entries, at = [], body_before
    for s in shards:
        entries.append(s.header() + at // wu)
        at += s.body_u32
    border_local = fmt.border_element_count(local_shape) * wu
    border_base = header_u32 + body_total
    return ShardStream(
        process_id=pid,
        num_processes=nproc,
        header_entries=_host_u32(entries),
        entry_offset=pid * num_hc_local,
        num_hc_global=num_hc,
        header_u32=header_u32,
        body_u32=_host_u32([s.body() for s in shards]),
        body_offset_u32=header_u32 + body_before,
        border_u32=_host_u32([s.border() for s in shards]),
        border_offset_u32=border_base + pid * border_local,
        total_u32=border_base + nproc * border_local,
    )


def gather_stream(shard: ShardStream) -> np.ndarray | None:
    """Send every process's spans to process 0 and assemble the whole stream
    there (returns None on the other processes). For tests and small files;
    large ones use ``write_to_file`` on a shared filesystem. Collective."""
    spans = (shard.header_entries, shard.body_u32, shard.border_u32)
    meta = [a.size for a in spans] + [shard.entry_offset, shard.body_offset_u32, shard.border_offset_u32]
    metas = [m.tolist() for m in _all_gather(torch.tensor(meta, dtype=torch.int64))]
    width = max(sum(m[:3]) for m in metas)
    flat = torch.zeros(width, dtype=torch.int32)
    flat[: sum(meta[:3])] = torch.from_numpy(np.concatenate(spans).view(np.int32))
    received = [torch.empty_like(flat) for _ in metas] if shard.process_id == 0 else None
    dist.gather(flat, received, dst=0, group=_group())
    if shard.process_id != 0:
        return None
    out = np.zeros(shard.total_u32, np.uint32)
    for (ne, nb, nr, eo, bo, ro), got in zip(metas, received):
        words = got.numpy().view(np.uint32)
        out[eo: eo + ne] = words[:ne]
        out[bo: bo + nb] = words[ne: ne + nb]
        out[ro: ro + nr] = words[ne + nb: ne + nb + nr]
    return out


def compress_to_file(local_slab, path: str, devices=None) -> int:
    """Compress and write one byte-exact stream file; returns its length in
    u32 words. ``path`` lies on a filesystem that every process sees.
    Collective."""
    shard = compress_multihost(local_slab, devices)
    if shard.process_id == 0:
        with open(path, "wb") as f:
            f.truncate(4 * shard.total_u32)
    dist.barrier(group=_group())
    shard.write_to_file(path)
    dist.barrier(group=_group())
    return shard.total_u32


def decompress_from_file(path: str, global_shape, dtype, devices=None) -> np.ndarray:
    """Decode this process's slab straight from a stream file with O(slab)
    IO: the file is memory-mapped, so each process reads only the pages of
    the header, its body span and its border span. Collective in the sense
    that every process calls it for its own slab."""
    return decompress_multihost(np.memmap(path, dtype=np.uint32, mode="r"), global_shape, dtype, devices)


def decompress_multihost(stream, global_shape, dtype, devices=None) -> np.ndarray:
    """Every process passes the whole stream (a uint32 array, or a memory map
    of a shared file) and receives its own slab, rows ``[rank * rows / n,
    (rank + 1) * rows / n)`` of the grid, decoded over its devices
    (``sharded.decompress_sharded``: one row slab a device)."""
    mesh = _local_mesh(devices)
    pid, nproc = dist.get_rank(), dist.get_world_size()
    global_shape = tuple(global_shape)
    dims = len(global_shape)
    side = fmt.SIDE_LENGTH[dims]
    wu = fmt.word_bits_for_dtype(np.dtype(dtype)) // 32
    if global_shape[0] % (nproc * side):
        raise ValueError("global axis 0 must divide into block-aligned slabs")
    num_hc = fmt.num_hypercubes(global_shape)
    if num_hc == 0:
        raise ValueError(f"global shape {global_shape} has no whole hypercube blocks; all-border grids must use a "
                         "single-device codec (api.make_decompressor)")
    local_shape = (global_shape[0] // nproc,) + global_shape[1:]
    header_u32 = fmt.header_u32_words(num_hc, 32 * wu)
    per_proc = num_hc // nproc
    offsets = np.asarray(stream[:num_hc]).astype(np.int64)

    lo, hi = pid * per_proc, (pid + 1) * per_proc
    base = int(offsets[lo - 1]) if lo else 0
    body_lo, body_hi = header_u32 + base * wu, header_u32 + int(offsets[hi - 1]) * wu
    border = fmt.border_element_count(local_shape) * wu
    border_at = header_u32 + int(offsets[-1]) * wu + pid * border
    head = fmt.header_u32_words(per_proc, 32 * wu)
    sub = np.zeros(head + (body_hi - body_lo) + border, np.uint32)
    sub[:per_proc] = offsets[lo:hi] - base
    sub[head: head + body_hi - body_lo] = stream[body_lo:body_hi]
    sub[head + body_hi - body_lo:] = stream[border_at: border_at + border]
    return sharded.decompress_sharded(sub, local_shape, dtype, mesh)
