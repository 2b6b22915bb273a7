"""Command-line compressor of the port, flag-compatible with
``ndzip_tpu/cli.py`` and the reference compress tool
(``src/compress/compress.cc:140-159``)::

    python -m ndzip_tpu_torch.cli -n 512 512 512 -t float -e cuda -i in.f32 -o out.ndz
    python -m ndzip_tpu_torch.cli -d -n 512 512 512 -t float -e cuda -i out.ndz -o back.f32

A file holding several arrays of the given extent is processed chunk by
chunk (compress.cc:17-86), through ``io``'s stdio or mmap streams
and ``api.make_offloader``. The output is byte for byte that of
``python -m ndzip_tpu.cli -e golden``. Prints the compression ratio and the
codec's time to stderr, as the reference does (compress.cc:48-56).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import api
from . import format as fmt
from . import io as ndz_io


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ndzip-tpu-torch",
                                description="ndzip-format lossless compressor (PyTorch/CUDA)")
    p.add_argument("-d", "--decompress", action="store_true", help="decompress (default: compress)")
    p.add_argument("-n", "--array-size", nargs="+", type=int, required=True,
                   metavar="N", help="array extents, first-major, 1-3 dims")
    p.add_argument("-t", "--data-type", choices=["float", "double"], default="float")
    p.add_argument("-e", "--encoder", choices=["auto", "cuda", "torch", "cpu", "golden", "sharded"],
                   help=f"codec backend (default: the one ${api.BACKEND_ENV} names where it is set, else cuda, "
                        "which fails without a GPU; 'auto' takes cuda where a GPU is present, else cpu or "
                        "golden; 'sharded' block-parallelizes over every visible GPU)")
    p.add_argument("-T", "--threads", type=int, default=0, help="CPU backend threads (0 = all cores)")
    p.add_argument("-i", "--input", default="-", help="input file (default stdin)")
    p.add_argument("-o", "--output", default="-", help="output file (default stdout)")
    p.add_argument("--no-mmap", action="store_true", help="use stdio instead of memory-mapping")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    shape = tuple(args.array_size)
    try:
        fmt.validate_shape(shape)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    dtype = np.float32 if args.data_type == "float" else np.float64
    itemsize = np.dtype(dtype).itemsize
    chunk_bytes = int(np.prod(shape)) * itemsize

    try:
        off = api.make_offloader(args.encoder, dtype, len(shape), threads=args.threads)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    use_mmap = not args.no_mmap
    inp = ndz_io.open_input(args.input, use_mmap)
    outp = ndz_io.open_output(args.output, use_mmap)
    in_bytes = out_bytes = codec_ns = nchunks = 0
    try:
        if not args.decompress:
            for raw in inp.read_exact(chunk_bytes):
                stream, _ = off.compress(np.frombuffer(raw, dtype=dtype).reshape(shape))
                codec_ns += off.timing.compress_ns
                outp.write_chunk(stream)
                in_bytes += chunk_bytes
                out_bytes += stream.nbytes
                nchunks += 1
        else:
            bound_bytes = fmt.compressed_bound_words(shape, itemsize * 8) * itemsize
            consumed = 0
            while (window := inp.read_some(bound_bytes, consumed)) is not None:
                clen = ndz_io.compressed_chunk_bytes(window, shape, dtype)
                if clen > len(window):
                    raise IOError(f"truncated compressed chunk: need {clen}, have {len(window)}")
                data = off.decompress(np.frombuffer(window[:clen], dtype=np.uint32), shape)
                codec_ns += off.timing.decompress_ns
                outp.write_chunk(np.ascontiguousarray(data))
                in_bytes += clen
                out_bytes += data.nbytes
                consumed = clen
                nchunks += 1
    except (IOError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        inp.close()
        outp.close()

    raw, compressed = (in_bytes, out_bytes) if not args.decompress else (out_bytes, in_bytes)
    if raw:
        print(f"raw = {raw} bytes, compressed = {compressed} bytes, ratio = {compressed / raw:.4f}, "
              f"codec time = {codec_ns / 1e6:.2f} ms ({args.encoder or 'default'}->{off.backend}, {nchunks} chunk(s))",
              file=sys.stderr)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
