"""Compare variants of the kernels' sources on one card, in one process.

A variant is a directory that holds a full copy of ``csrc/`` with some file
changed (for example the parent commit's sources beside this tree's). Two
commands, both for a machine with nvcc and a GPU:

``python -m ndzip_tpu_torch.variants time DIR [DIR ...] [--shapes 256x256x256 ...] [--dtype float64]``
    builds each directory into its own library, checks on every shape that
    all variants give the first variant's stream and give the input back,
    then times the encode and decode kernels of each variant in turns
    (A, B, ..., A, B, ...): ``--reps`` launches back to back with a CUDA
    event between every two, all queued behind a spin kernel so that the
    events hold the device's time and not the host's time to enqueue a
    launch (which exceeds a small grid's kernels), ``--rounds`` rounds
    after one that warms up; it
    prints the median of all launches in us, each round's median, the least
    and the greatest launch, and the first launch of each round, which
    follows another kernel or a pause, and beside the median the kernel's
    bound: the bytes it must move (the input read once, the stream written
    or read once at this run's length), the time the card's memory needs for
    them at ``HBM_BYTES_PER_S`` and that bound over the median. 1D shapes go
    to the 1D kernels,
    2D/3D shapes to the nd kernels, of the fp32 profile or, with ``--dtype
    float64``, of the fp64 one (int64 words, the fp64 stream bound). Prints
    what ``ptxas -v`` says of the kernels whose name contains ``--ptxas``.

``python -m ndzip_tpu_torch.variants sass DIR_A DIR_B [--same FILE.cu ...]``
    compiles each ``.cu`` of both directories to a cubin, dumps its SASS with
    ``cuobjdump -sass`` and says per file how many kernels the two sides
    share, how many of those are identical instruction for instruction, which
    differ and which exist on one side only; exits nonzero if a kernel of a
    file named by ``--same`` differs.

The data is ``sin`` of the flat index plus noise, made on the card from a
seed; the numbers say which variant is faster on this card, in this call.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

#: the H100 SXM's memory rate (NVIDIA's data sheet), which bounds every codec kernel
HBM_BYTES_PER_S = 3.35e12
ENTRY_POINTS = ["ndzip_encode_fp32", "ndzip_decode_fp32", "ndzip_encode_fp32_nd", "ndzip_decode_fp32_nd",
                "ndzip_encode_fp64", "ndzip_decode_fp64", "ndzip_encode_fp64_nd", "ndzip_decode_fp64_nd"]


def _shape(text: str) -> tuple[int, ...]:
    return tuple(int(e) for e in text.lower().split("x"))


class Variant:
    """One directory of sources, built and loaded, whose codec kernels launch
    as ``codec_cuda`` launches its own: the entry point and the integer
    arguments of the launch plan (``codec_cuda._plan``) for the words' shape
    and dtype (int32 words for fp32, int64 for fp64)."""

    def __init__(self, csrc: Path):
        from . import _build

        self.name = str(csrc)
        self.csrc = csrc
        self.lib = _build.load_from(csrc, ENTRY_POINTS)

    def _entry(self, op: str, shape, word_dtype):
        """This library's entry point of ``op`` for the shape, and the plan
        that gives its integer arguments."""
        from . import codec_cuda

        plan = codec_cuda._kernel_plan(op, tuple(shape), word_dtype, 0)
        return getattr(self.lib, plan.fn.__name__), plan

    def encode(self, words, stream, scratch):
        """Encode ``words`` into ``stream``; ``scratch`` holds the status
        words and the length after them, as ``codec_cuda._encode`` sizes it."""
        from . import codec_cuda

        fn, plan = self._entry("encode", words.shape, words.dtype)
        status = scratch.data_ptr()
        codec_cuda._launch(fn, plan.index, words.data_ptr(), *plan.args, stream.data_ptr(), status,
                           status + 4 * (scratch.numel() - 1))

    def decode(self, stream, out):
        from . import codec_cuda

        fn, plan = self._entry("decode", out.shape, out.dtype)
        codec_cuda._launch(fn, plan.index, stream.data_ptr(), stream.numel(), *plan.args, out.data_ptr())


def _us_of_launches(fn, reps: int) -> list[float]:
    """The device time of each of ``reps`` launches back to back, in us: an
    event between every two, all queued behind a spin kernel
    (``utils.event_time_ms(queued=True)``), read when all have run."""
    import torch

    from . import utils

    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]

    def launches():
        events[0].record()
        for e in events[1:]:
            fn()
            e.record()

    utils.event_time_ms(launches, queued=True)
    return [a.elapsed_time(b) * 1e3 for a, b in zip(events, events[1:])]


def time_variants(dirs, shapes, reps: int, rounds: int, ptxas: list[str], dtype: str = "float32") -> int:
    import torch

    from . import _build, utils
    from . import format as fmt

    if not torch.cuda.is_available():
        raise SystemExit("variants: needs an NVIDIA GPU")
    card = utils.card()
    variants = [Variant(Path(d)) for d in dirs]
    for v in variants:
        for pattern in ptxas:
            for line in _build.ptxas_lines(pattern, v.csrc):
                print(f"[ptxas] {v.name}: {line}", flush=True)
    dev = torch.device("cuda", 0)
    for shape in shapes:
        n = 1
        for e in shape:
            n *= e
        gen = torch.Generator(device=dev).manual_seed(0)
        float_type, word_type = (torch.float64, torch.int64) if dtype == "float64" else (torch.float32, torch.int32)
        x = torch.sin(torch.arange(n, device=dev, dtype=float_type) * 1e-4)
        x += 1e-3 * torch.randn(n, device=dev, generator=gen, dtype=float_type)
        words = x.view(word_type).reshape(shape)
        del x
        num_hc = fmt.num_hypercubes(shape)
        bound = fmt.compressed_bound_u32(shape, 8 * words.element_size())
        scratch = torch.empty(2 * (num_hc + 1) + 1, dtype=torch.int32, device=dev)
        length = scratch[-1]
        first, out = None, torch.empty_like(words)
        for v in variants:
            stream = torch.full((bound,), -1, dtype=torch.int32, device=dev)
            v.encode(words, stream, scratch)
            L = int(length)
            if first is None:
                first = stream[:L].clone()
            elif L != first.numel() or not torch.equal(stream[:L], first):
                raise SystemExit(f"variants: {v.name} gives another stream than {variants[0].name} on {shape}")
            out.fill_(-1)
            v.decode(first, out)
            if not torch.equal(out, words):
                raise SystemExit(f"variants: {v.name} does not give the input back on {shape}")
        stream = torch.empty(bound, dtype=torch.int32, device=dev)
        times = {(v.name, what): [] for v in variants for what in ("encode", "decode")}
        for _ in range(rounds + 1):  # the first round warms up
            for v in variants:
                for what, fn in (("encode", lambda v=v: v.encode(words, stream, scratch)),
                                 ("decode", lambda v=v: v.decode(first, out))):
                    times[v.name, what].append(_us_of_launches(fn, reps))
        label = "x".join(map(str, shape)) + (" fp64" if dtype == "float64" else "")
        moved = n * words.element_size() + 4 * first.numel()  # input or output, and the stream, once each
        bound_us = moved / HBM_BYTES_PER_S * 1e6
        for (name, what), per_round in times.items():
            every = [us for one_round in per_round[1:] for us in one_round]
            median = statistics.median(every)
            print(f"[time] {label} {what} {name}: {median:.2f} us a launch (median of {rounds} "
                  f"rounds of {reps} launches back to back; rounds "
                  f"{' '.join(f'{statistics.median(r):.2f}' for r in per_round[1:])}; least {min(every):.2f}, "
                  f"greatest {max(every):.2f}; the first launch of each round "
                  f"{' '.join(f'{r[0]:.2f}' for r in per_round[1:])}); ratio {4 * first.numel() / (n * words.element_size()):.4f}; "
                  f"{moved / 1e6:.1f} MB in + out, bound {bound_us:.2f} us at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                  f"bound / median {bound_us / median:.1%} on {card}",
                  flush=True)
        del words, stream, out, first
        torch.cuda.empty_cache()
    return 0


def _kernels_sass(nvcc: str, src: Path, tmp: Path) -> dict[str, str]:
    """The SASS of each kernel of one source, by its mangled name."""
    from . import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cubin = tmp / f"{src.parent.parent.name}_{src.parent.name}_{src.stem}.cubin"
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True, capture_output=True)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True, text=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    # a kernel's instructions and their encodings: the lines that hold a /* ... */ field; what
    # cuobjdump prints between two kernels goes with neither
    return {name: "\n".join(line.strip() for line in body.splitlines() if "/*" in line)
            for name, body in zip(parts[1::2], parts[2::2])}


def compare_sass(dir_a: Path, dir_b: Path, same: list[str]) -> int:
    from . import _build

    nvcc = _build._find_nvcc()
    if nvcc is None:
        raise SystemExit("variants: nvcc not found")
    changed_files = []
    with tempfile.TemporaryDirectory() as tmp:
        for src_a in sorted(dir_a.glob("*.cu")):
            src_b = dir_b / src_a.name
            if not src_b.exists():
                print(f"[sass] {src_a.name}: only in {dir_a}", flush=True)
                continue
            a, b = _kernels_sass(nvcc, src_a, Path(tmp)), _kernels_sass(nvcc, src_b, Path(tmp))
            both = sorted(a.keys() & b.keys())
            differ = [k for k in both if a[k] != b[k]]
            one_side = sorted(a.keys() ^ b.keys())
            if differ:
                changed_files.append(src_a.name)
            print(f"[sass] {src_a.name}: {len(both)} kernels on both sides, {len(both) - len(differ)} identical"
                  + (f"; differing: {', '.join(differ)}" if differ else "")
                  + (f"; on one side only: {', '.join(one_side)}" if one_side else ""), flush=True)
    broken = sorted(set(same) & set(changed_files))
    if broken:
        print(f"[sass] FAILED: kernels of {', '.join(broken)} should be identical and are not", flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ndzip_tpu_torch.variants", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    t = sub.add_parser("time")
    t.add_argument("dirs", nargs="+")
    t.add_argument("--shapes", nargs="+", type=_shape, default=[(256, 256, 256), (512, 512, 2048)])
    t.add_argument("--reps", type=int, default=20)
    t.add_argument("--rounds", type=int, default=3)
    t.add_argument("--ptxas", nargs="*", default=["blocks_nd"])
    t.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    s = sub.add_parser("sass")
    s.add_argument("dir_a", type=Path)
    s.add_argument("dir_b", type=Path)
    s.add_argument("--same", nargs="*", default=[])
    args = p.parse_args(argv)
    if args.command == "time":
        return time_variants(args.dirs, args.shapes, args.reps, args.rounds, args.ptxas, args.dtype)
    return compare_sass(args.dir_a, args.dir_b, args.same)


if __name__ == "__main__":
    sys.exit(main())
