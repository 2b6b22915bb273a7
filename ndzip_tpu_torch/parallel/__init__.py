"""The block-parallel layer of the port: ``sharded`` over a list of devices
in one process, ``multihost`` over ``torch.distributed`` processes. The
counterpart of ``ndzip_tpu/parallel``."""

from __future__ import annotations

import numpy as np
import torch

from . import multihost  # noqa: F401
from .sharded import (  # noqa: F401
    compress_sharded,
    compress_sharded_device,
    decompress_sharded,
    decompress_sharded_device,
    make_mesh,
)


def _expect(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n: int, devices=None) -> None:
    """A block-parallel compress and decompress over ``n`` shards, placed
    round robin on ``devices`` (default: every visible CUDA device, see
    ``make_mesh``): the cases of ``__graft_entry__.dryrun_multichip``. Four
    host cases (1D fp32 with a border, 2D fp64, 3D fp32 with a border, an
    uneven block grid) and one device-resident case, each stream equal to
    the port's ``golden.compress`` and each round trip bit-exact; raises
    AssertionError otherwise."""
    from .. import golden

    devs = make_mesh(devices)
    mesh = tuple(devs[i % len(devs)] for i in range(n))
    rng = np.random.default_rng(1)
    cases = [((4096 * 2 * n + 17,), np.float32),
             ((64 * n, 130), np.float64),
             ((16 * n, 16, 33), np.float32),
             ((4096 * (2 * n - 1) + 17,), np.float32)]
    for shape, dtype in cases:
        data = rng.standard_normal(shape).astype(dtype)
        what = f"{shape} {np.dtype(dtype).name}"
        stream, length = compress_sharded(data, mesh)
        expect, elen = golden.compress(data)
        _expect(length == elen and stream.tobytes() == expect.tobytes(), f"{what}: sharded stream != serial stream")
        out = decompress_sharded(stream, shape, dtype, mesh)
        _expect(np.array_equal(out.view(np.uint8), data.view(np.uint8)), f"{what}: sharded round trip failed")

    shape = (4096 * 2 * n + 17,)
    data = rng.standard_normal(shape).astype(np.float32)
    expect, elen = golden.compress(data)
    x = torch.from_numpy(data).to(mesh[0])
    stream, length = compress_sharded_device(x, mesh)
    length = int(length)
    _expect(length == elen and stream[:length].cpu().numpy().tobytes() == expect.tobytes(),
            "device-resident sharded stream != serial stream")
    slabs = decompress_sharded_device(stream[:length], shape, np.float32, mesh)
    _expect(torch.equal(torch.cat([s.to(mesh[0]) for s in slabs]).view(torch.int32), x.view(torch.int32)),
            "device-resident sharded round trip failed")
