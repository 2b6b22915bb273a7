"""Warm the port's kernels before a deployment's first call: the
counterpart of ``ndzip_tpu/warm.py``::

    python -m ndzip_tpu_torch.warm --shapes 16777216 1800x3600 --dtype float double

Builds the CUDA kernels' library from ``csrc/`` with nvcc (or finds the one
built from the same sources; ``_build``) and prints its name and the
seconds it took, then compresses and decompresses zeros of every shape and
dtype once on the card, so each kernel is loaded, and checks the round trip.
Exits 1 on a mismatch or a shape the format cannot hold, and nonzero with
the message on a machine without a GPU or nvcc.

The JAX tool's knobs (``--peak``, ``--win-rows``, ``--cache-dir``) tune and
fill a persistent cache of Mosaic compiles. The port's kernels are compiled
ahead of time into one library and have no per-shape program, so there is
nothing for them to tune on Hopper and they are not carried over.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import _build, codec_cuda
from . import format as fmt


def _parse_shape(s: str) -> tuple:
    try:
        return tuple(int(x) for x in s.replace(",", "x").split("x") if x)
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad shape {s!r}; use e.g. 512x512x512")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ndzip-tpu-torch-warm",
                                description="build the CUDA kernels and load them for planned shapes")
    p.add_argument("--shapes", nargs="+", type=_parse_shape, required=True,
                   metavar="DxDxD", help="array extents, e.g. 16777216 1800x3600")
    p.add_argument("--dtype", nargs="+", choices=["float", "double"], default=["float"],
                   help="dtypes to warm (default: float)")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("error: warm needs an NVIDIA GPU: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    lib = _build.library_path()
    found = lib.exists()
    try:
        _build.load()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"kernel library {lib.name}: {'found' if found else 'built'} and loaded in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)

    rc = 0
    for shape in args.shapes:
        for tname in args.dtype:
            dtype = torch.float32 if tname == "float" else torch.float64
            try:
                fmt.validate_shape(shape)
            except ValueError as e:
                print(f"skip {shape} {tname}: {e}", file=sys.stderr)
                rc = 1
                continue
            t0 = time.perf_counter()
            zeros = torch.zeros(shape, dtype=dtype, device="cuda")
            stream, length = codec_cuda.compress_device(zeros)
            length = int(length)
            t1 = time.perf_counter()
            out = codec_cuda.decompress_device(stream[:length], shape, dtype)
            ok = torch.equal(out, zeros)
            t2 = time.perf_counter()
            print(f"warmed {'x'.join(map(str, shape))} {tname}: encode {t1 - t0:.2f}s decode {t2 - t1:.2f}s"
                  f"{'' if ok else '  ROUND-TRIP MISMATCH'}", file=sys.stderr)
            rc |= not ok
    return int(rc)


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
