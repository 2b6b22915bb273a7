#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ndzip (``ndzip_tpu_torch``) once on one GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases, one
line each, and any failure raises and exits nonzero:

1. device: the card's name, ``nvidia-smi``'s name and power limit, versions;
2. build: the CUDA kernels from ``ndzip_tpu_torch/csrc`` with nvcc, one nvcc
   per source, all started together;
3. each kernel against its plain PyTorch version on the card, exact: the 1D
   kernels on small fp32 1D cases (borders, zeros, incompressible bits,
   constants, one block, special floats), the 2D/3D kernels on small grids
   (aligned and unaligned rows, borders on one or two axes, constants, random
   bits, special floats), and one all-border grid through the glue; then the
   four fp64 kernels on tests/test_pallas.py's fp64 shapes (an odd block
   count with the header's pad word, borders, 2D/3D) and on zeros, random
   64-bit words, a constant, special floats and one all-border grid; each
   decode reads the plain stream with -1 written past its length;
4. the paths through the public entry points: ``compress_device`` then
   ``decompress_device(stream[:length], shape, dtype)``, fp32 1D at 2^24
   elements (bench.py's headline data) and 2^28 + 17, fp32 2D/3D at
   bench.py's CESM 1800x3600, 256^3 and 512x512x2048 (2 GiB) cells, then
   fp64 at bench.py's 1D 2^23 and 512^3 (1 GiB) cells: streams equal to the
   plain version's on the card, bit-exact round trips, and the kernels'
   launch counts over each path, counted from 0 just before it. The tests
   hold the plain version's stream against the reference package byte for
   byte; this script imports nothing of that package;
5. timing with CUDA events: median of 10 runs after a warm-up, compress and
   decompress against the plain version and a device-to-device ``copy_``,
   per size and cell; then each kernel's mean device time per call from
   ``torch.profiler``.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

REPS = 10
SEED = 0


def fail(what: str):
    raise SystemExit(f"chip_smoke FAILED: {what}")


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the 32-bit words of int32 or int64 tensors of
    equal shape (0 when bit-identical). An int64 word counts as its two u32
    halves, whose difference cannot overflow."""
    import torch

    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.dtype == torch.int64:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a.long() - b.long()).abs().max())


def bench_data(n: int) -> np.ndarray:
    """bench.py's headline data: sin(i * 1e-4) + 1e-3 * N(0, 1), seed 0."""
    rng = np.random.default_rng(SEED)
    return (np.sin(np.arange(n, dtype=np.float32) * 1e-4)
            + 0.001 * rng.standard_normal(n).astype(np.float32))


def cesm_data() -> np.ndarray:
    """bench.py's CESM cell: sin(y) cos(x) + 1e-3 * N(0, 1) on 1800x3600, seed 0."""
    rng = np.random.default_rng(SEED)
    y = np.linspace(0, 11.0, 1800, dtype=np.float64)[:, None]
    x = np.linspace(0, 7.0, 3600, dtype=np.float64)[None, :]
    return (np.sin(y) * np.cos(x) + 0.001 * rng.standard_normal((1800, 3600))).astype(np.float32)


def cube_data() -> np.ndarray:
    """bench.py's 256^3 cell: sin(z) cos(y) sin(2x) + 1e-3 * N(0, 1), seed 0."""
    rng = np.random.default_rng(SEED)
    z = np.linspace(0, 5.0, 256, dtype=np.float64)
    return (np.sin(z[:, None, None]) * np.cos(z[None, :, None]) * np.sin(z[None, None, :] * 2)
            + 0.001 * rng.standard_normal((256, 256, 256))).astype(np.float32)


def big_cube(dev):
    """bench.py's 2 GiB cell, 512x512x2048: sin(z) cos(y) sin(x) + 1e-3 * N(0, 1),
    made on the card with a torch.Generator seeded with SEED."""
    import torch

    z = torch.linspace(0, 9.0, 512, device=dev)
    x = torch.linspace(0, 4.0, 2048, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = torch.sin(z[:, None, None]) * torch.cos(z[None, :, None]) * torch.sin(x[None, None, :])
    return d + 1e-3 * torch.randn((512, 512, 2048), device=dev, generator=gen)


def bench_data64(n: int) -> np.ndarray:
    """bench.py's fp64 1D cell: sin(i * 1e-4) + 1e-3 * N(0, 1) in float64, seed 0."""
    rng = np.random.default_rng(SEED)
    return np.sin(np.arange(n, dtype=np.float64) * 1e-4) + 0.001 * rng.standard_normal(n)


def cube64(dev):
    """bench.py's fp64 512^3 cell (1 GiB): sin(z) cos(y) sin(2x) + 1e-3 * N(0, 1)
    in float64, made on the card with a torch.Generator seeded with SEED."""
    import torch

    z = torch.linspace(0, 9.0, 512, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = torch.sin(z[:, None, None]) * torch.cos(z[None, :, None]) * torch.sin(2 * z[None, None, :])
    return d + 1e-3 * torch.randn((512, 512, 512), dtype=torch.float64, device=dev, generator=gen)


def kernel_breakdown(fn) -> str:
    """Mean device time per call of each CUDA kernel ``fn`` launches, from
    torch.profiler over REPS calls (the profiler's cost is inside)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / REPS, e.key.split("(")[0]) for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.device_time_total), reverse=True)
    return "; ".join(f"{key} {us:.2f}" for us, key in rows)


def kernel_cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(SEED)

    def normal(n):
        d = rng.standard_normal(n).astype(np.float32)
        d[:200] = 0
        d[300:340] = d[299]
        return d

    special = normal(4096 * 8 + 37)
    special[[5, 4100, 9000]] = np.nan
    special[[6, 4101]] = np.inf
    special[[7, 20000]] = -np.inf
    special[[8, 4102, 32790]] = -0.0
    special[1000:1064] = np.float32(1e-42) * np.arange(64, dtype=np.float32)  # denormals
    return {
        "4096*8": normal(4096 * 8),
        "4096*8+100": normal(4096 * 8 + 100),
        "all zeros": np.zeros(4096 * 8, np.float32),
        "random bits": rng.integers(0, 2**32, 4096 * 8, dtype=np.uint64).astype(np.uint32),
        "constant": np.full(4096 * 8, 3.25, np.float32),
        "single block": normal(4096),
        "nan/inf/-0/denormal": special,
    }


def nd_kernel_cases() -> dict[str, np.ndarray]:
    """Small 2D/3D grids for the nd kernels: tests/test_pallas.py's shapes
    (rows 16-byte aligned or not, borders on none, one or two axes),
    constants, random bits, special floats, and one all-border grid."""
    rng = np.random.default_rng(SEED)

    def normal(shape):
        d = rng.standard_normal(shape).astype(np.float32)
        d.reshape(-1)[:200] = 0
        d.reshape(-1)[300:340] = d.reshape(-1)[299]
        return d

    special = normal((32, 32, 48))
    flat = special.reshape(-1)
    flat[[5, 4100, 9000]] = np.nan
    flat[[6, 4101]] = np.inf
    flat[[7, 20000]] = -np.inf
    flat[[8, 4102, 32790]] = -0.0
    flat[1000:1064] = np.float32(1e-42) * np.arange(64, dtype=np.float32)  # denormals
    return {
        "2d (128,192)": normal((128, 192)),
        "2d (128,512)": normal((128, 512)),
        "2d border (130,513)": normal((130, 513)),
        "3d border (32,32,33)": normal((32, 32, 33)),
        "3d (16,32,128)": normal((16, 32, 128)),
        "3d border (17,32,129)": normal((17, 32, 129)),
        "3d constant (32,32,32)": np.full((32, 32, 32), 3.25, np.float32),
        "2d random bits (128,256)": rng.integers(0, 2**32, (128, 256), dtype=np.uint64).astype(np.uint32),
        "3d nan/inf/-0/denormal (32,32,48)": special,
        "2d all border (63,100)": normal((63, 100)),
    }


def fp64_kernel_cases() -> dict[str, np.ndarray]:
    """Small fp64 grids for the four fp64 kernels: tests/test_pallas.py's
    SHAPES64 (1D with an odd block count, the header's pad word and a border;
    2D/3D with borders, minor extents even (16-byte rows) and odd (one word a
    lane)), zeros, random 64-bit words (every block at its 4160-word
    maximum), a constant, special floats, and one all-border grid."""
    rng = np.random.default_rng(SEED)

    def normal(shape):
        d = rng.standard_normal(shape)
        d.reshape(-1)[:200] = 0
        d.reshape(-1)[300:340] = d.reshape(-1)[299]
        return d

    def special(shape):
        d = normal(shape)
        flat = d.reshape(-1)
        flat[[5, 4100, 9000]] = np.nan
        flat[[9, 4103]] = np.array([0x7FF0000000000001, 0xFFF80000DEADBEEF], np.uint64).view(np.float64)
        flat[[6, 4101]] = np.inf
        flat[[7, 20000]] = -np.inf
        flat[[8, 4102, 32790]] = -0.0
        flat[1000:1064] = 5e-324 * np.arange(64)  # denormals
        return d

    return {
        "1d 4096*8": normal(4096 * 8),
        "1d odd block count + border 4096*3+1": normal(4096 * 3 + 1),
        "1d all zeros": np.zeros(4096 * 8),
        "1d random bits": rng.integers(0, 2**64, 4096 * 8, dtype=np.uint64).view(np.float64),
        "1d constant": np.full(4096 * 8, 3.25),
        "1d nan/inf/-0/denormal": special(4096 * 8 + 37),
        "2d border (128,70)": normal((128, 70)),
        "3d (16,32,32)": normal((16, 32, 32)),
        "2d (128,512)": normal((128, 512)),
        "3d border (17,16,128)": normal((17, 16, 128)),
        "3d odd minor extent (17,32,129)": normal((17, 32, 129)),
        "2d random bits (128,192)": rng.integers(0, 2**64, (128, 192), dtype=np.uint64).view(np.float64),
        "3d nan/inf/-0/denormal (32,32,48)": special((32, 32, 48)),
        "3d all border (15,16,200)": normal((15, 16, 200)),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")

    import ndzip_tpu_torch as nt
    from ndzip_tpu_torch import _build, codec_cuda, codec_torch
    from ndzip_tpu_torch.codec_torch import HC

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(f"[1 device] {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"cards: {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    err = dict.fromkeys(codec_cuda.LAUNCHES, 0)

    def cuda_words(data: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(data).view(np.int32 if data.itemsize == 4 else np.int64)).to(dev)

    # ---- 3. each kernel against its plain version, exact
    for label, data in kernel_cases().items():
        w = cuda_words(data)
        n = w.numel()
        num_hc = n // HC
        stream, length = codec_cuda._encode_blocks_fp32(w)
        header, body, lengths = codec_torch.encode_blocks_ref(w[: num_hc * HC].reshape(num_hc, HC))
        ref_stream, ref_length = codec_torch.encode(w)
        L, body_total = int(length), int(header[-1])
        e = max(max_abs_err(stream[:num_hc], header),
                max_abs_err(stream[num_hc: num_hc + body_total], body),
                max_abs_err(stream[:L], ref_stream[: int(ref_length)]))
        err["encode"] = max(err["encode"], e)
        if e or L != int(ref_length):
            fail(f"encode kernel != plain on {label!r} (max_abs_err {e}, length {L} vs {int(ref_length)})")
        if label == "random bits" and int(lengths.min()) != HC + HC // 32:
            fail("random bits did not give every block the 4224-word maximum")
        # decode from the plain stream with garbage past its length
        garbage = ref_stream.clone()
        garbage[L:] = -1
        out = codec_cuda._decode_blocks_fp32(garbage, n)
        e = max(max_abs_err(out[: num_hc * HC], codec_torch.decode_blocks_ref(garbage, num_hc).reshape(-1)),
                max_abs_err(out, codec_torch.decode(ref_stream, (n,))))
        err["decode"] = max(err["decode"], e)
        if e or not torch.equal(out, w):
            fail(f"decode kernel != plain or != input on {label!r} (max_abs_err {e})")
        print(f"[3 kernels] {label}: n={n} blocks={num_hc} length={L} encode == plain, "
              f"decode == plain == input", flush=True)

    for label, data in nd_kernel_cases().items():
        w = cuda_words(data)
        shape, dims = tuple(w.shape), w.dim()
        num_hc = math.prod(e // {2: 64, 3: 16}[dims] for e in shape)
        ref_stream, ref_length = codec_torch.encode(w)
        L = int(ref_length)
        garbage = ref_stream.clone()
        garbage[L:] = -1
        if num_hc == 0:  # all border: the glue copies, no kernel runs
            stream, length = nt.compress_device(w)
            out = nt.decompress_device(garbage, shape, torch.int32)
            if int(length) != L or max_abs_err(stream, ref_stream) or not torch.equal(out, w):
                fail(f"all-border glue != plain on {label!r}")
            print(f"[3 kernels] {label}: all border, glue == plain == input", flush=True)
            continue
        stream, length = codec_cuda._encode_interior_fp32(w)
        header, body, _ = codec_torch.encode_blocks_ref(codec_torch.gather_blocks(w, shape), dims)
        body_total = int(header[-1])
        e = max(max_abs_err(stream[:num_hc], header),
                max_abs_err(stream[num_hc: num_hc + body_total], body),
                max_abs_err(stream[:L], ref_stream[:L]) if int(length) == L else -1)
        err["encode_nd"] = max(err["encode_nd"], e)
        if e:
            fail(f"nd encode kernel != plain on {label!r} (max_abs_err {e}, length {int(length)} vs {L})")
        out = codec_cuda._decode_interior_fp32(garbage, shape)
        blocks = codec_torch.decode_blocks_ref(garbage, num_hc, dims)
        e = max(max_abs_err(codec_torch.gather_blocks(out, shape), blocks),
                max_abs_err(out, codec_torch.decode(ref_stream, shape)))
        err["decode_nd"] = max(err["decode_nd"], e)
        if e or not torch.equal(out, w):
            fail(f"nd decode kernel != plain or != input on {label!r} (max_abs_err {e})")
        print(f"[3 kernels] {label}: blocks={num_hc} length={L} nd encode == plain, "
              f"nd decode == plain == input", flush=True)

    for label, data in fp64_kernel_cases().items():
        w = cuda_words(data)
        shape, dims = tuple(w.shape), w.dim()
        num_hc = math.prod(e // {1: HC, 2: 64, 3: 16}[dims] for e in shape)
        ref_stream, ref_length = codec_torch.encode(w)
        L = int(ref_length)
        garbage = ref_stream.clone()
        garbage[L:] = -1
        if num_hc == 0:  # all border: the glue copies, no kernel runs
            stream, length = nt.compress_device(w)
            out = nt.decompress_device(garbage, shape, torch.int64)
            if int(length) != L or max_abs_err(stream, ref_stream) or not torch.equal(out, w):
                fail(f"fp64 all-border glue != plain on {label!r}")
            print(f"[3 kernels fp64] {label}: all border, glue == plain == input", flush=True)
            continue
        enc, dec = ("encode64", "decode64") if dims == 1 else ("encode64_nd", "decode64_nd")
        if dims == 1:
            stream, length = codec_cuda._encode_blocks_fp64(w)
        else:
            stream, length = codec_cuda._encode_interior_fp64(w)
        header, body, lengths = codec_torch.encode_blocks_ref(codec_torch.gather_blocks(w, shape), dims)
        hw2, body_total = 2 * ((num_hc + 1) // 2), int(header[-1])  # u32 words of header and pad
        same_length = int(length) == L
        e = max(max_abs_err(stream[:num_hc], header),
                max_abs_err(stream[hw2: hw2 + 2 * body_total].view(torch.int64), body),
                max_abs_err(stream[:L], ref_stream[:L]) if same_length else -1)
        differing = int((stream[:L] != ref_stream[:L]).sum()) if same_length else -1
        err[enc] = max(err[enc], e)
        if e or differing:
            fail(f"fp64 encode kernel != plain on {label!r} (max_abs_err {e}, {differing} differing "
                 f"u32 words, length {int(length)} vs {L})")
        if "random bits" in label and int(lengths.min()) != HC + HC // 64:
            fail("random bits did not give every fp64 block the 4160-word maximum")
        out = (codec_cuda._decode_blocks_fp64(garbage, shape[0]) if dims == 1
               else codec_cuda._decode_interior_fp64(garbage, shape))
        blocks = codec_torch.decode_blocks_ref(garbage, num_hc, dims, 64)
        e = max(max_abs_err(codec_torch.gather_blocks(out, shape), blocks),
                max_abs_err(out, codec_torch.decode(ref_stream, shape, 64)))
        differing = int((out != w).sum())
        err[dec] = max(err[dec], e)
        if e or differing:
            fail(f"fp64 decode kernel != plain or != input on {label!r} (max_abs_err {e}, "
                 f"{differing} words differ from the input)")
        print(f"[3 kernels fp64] {label}: blocks={num_hc} length={L} u32 words, {enc} == plain, "
              f"{dec} == plain == input (0 differing words)", flush=True)

    def kernel_keys(x):
        """The LAUNCHES keys of the encode and decode kernels that take ``x``."""
        suffix = ("64" if x.element_size() == 8 else "") + ("_nd" if x.dim() > 1 else "")
        return "encode" + suffix, "decode" + suffix

    def check_cell(x, s, L, y, what):
        """The kernels' stream and output of one cell against the plain versions on the card."""
        shape, bits = tuple(x.shape), x.element_size() * 8
        w = codec_torch.as_words(x)
        if not torch.equal(codec_torch.as_words(y), w):
            fail(f"{what}: round trip is not bit-exact")
        ps, pl = codec_torch.encode(w)
        e = max_abs_err(s[:L], ps[: int(pl)]) if L == int(pl) else -1
        enc, dec = kernel_keys(x)
        err[enc] = max(err[enc], e)
        if e:
            fail(f"{what}: kernel stream differs from the plain version's on the card")
        del ps
        e = max_abs_err(codec_torch.as_words(y), codec_torch.decode(s[:L], shape, bits))
        err[dec] = max(err[dec], e)
        if e:
            fail(f"{what}: kernel decode differs from the plain version's on the card")

    # ---- 4. the fp32 1D path, through the public entry points
    n24, n28 = 2**24, 2**28 + 17
    x24 = torch.from_numpy(bench_data(n24)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x28 = (torch.sin(torch.arange(n28, device=dev, dtype=torch.float32) * 1e-4)
           + 1e-3 * torch.randn(n28, device=dev, generator=gen))
    torch.cuda.synchronize()

    for k in codec_cuda.LAUNCHES:
        codec_cuda.LAUNCHES[k] = 0
    s24, l24 = nt.compress_device(x24)
    L24 = int(l24)
    y24 = nt.decompress_device(s24[:L24], (n24,))
    s28, l28 = nt.compress_device(x28)
    L28 = int(l28)
    y28 = nt.decompress_device(s28[:L28], (n28,))
    torch.cuda.synchronize()
    launches = dict(codec_cuda.LAUNCHES)
    if launches["encode"] == 0 or launches["decode"] == 0:
        fail(f"the 1D path did not launch every 1D kernel: {launches}")

    check_cell(x24, s24, L24, y24, "2^24")
    check_cell(x28, s28, L28, y28, "2^28+17")
    print(f"[4 path 1D] 2^24: stream == plain ({L24} words, ratio {L24 / n24:.4f}), round trip "
          f"bit-exact; 2^28+17: stream == plain ({L28} words, ratio {L28 / n28:.4f}), round trip "
          f"bit-exact; launches {launches}", flush=True)
    del s24, y24, s28, y28
    torch.cuda.empty_cache()

    # ---- 5. timing with CUDA events
    def median_ms(fn) -> float:
        fn()
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def time_cell(x, label):
        """Phase 5 for one size or cell; returns the timed rows."""
        shape, bits = tuple(x.shape), x.element_size() * 8
        w = codec_torch.as_words(x)
        s, length = nt.compress_device(x)
        sl = s[: int(length)]
        dst = torch.empty_like(x)
        gb = x.numel() * x.element_size() / 1e9
        rows = {
            "compress": median_ms(lambda: nt.compress_device(x)),
            "compress plain": median_ms(lambda: codec_torch.encode(w)),
            "decompress": median_ms(lambda: nt.decompress_device(sl, shape, x.dtype)),
            "decompress plain": median_ms(lambda: codec_torch.decode(sl, shape, bits)),
            "copy_": median_ms(lambda: dst.copy_(x)),
        }
        for what, ms in rows.items():
            print(f"[5 time] {label} ({gb * 1e3 / 1.048576:.1f} MiB) {what}: {ms:.4f} ms = "
                  f"{gb / (ms * 1e-3):.1f} GB/s (uncompressed bytes / time, median of {REPS}) "
                  f"on {card}", flush=True)
        for what, fn in (("compress", lambda: nt.compress_device(x)),
                         ("decompress", lambda: nt.decompress_device(sl, shape, x.dtype))):
            print(f"[5 profile] {label} {what}, mean device us per call by kernel over {REPS} calls: "
                  f"{kernel_breakdown(fn)} on {card}", flush=True)
        return rows, sl

    kernel_ms = {}
    rows, sl = time_cell(x24, f"n={n24}")
    w24 = x24.view(torch.int32)
    kernel_ms["encode"] = (median_ms(lambda: codec_cuda._encode_blocks_fp32(w24)), rows["compress plain"])
    kernel_ms["decode"] = (median_ms(lambda: codec_cuda._decode_blocks_fp32(sl, n24)),
                           rows["decompress plain"])
    time_cell(x28, f"n={n28}")
    del x24, x28, sl
    torch.cuda.empty_cache()

    # ---- 4 and 5 for the fp32 2D/3D path, one cell at a time
    cells = (("CESM 1800x3600", lambda: torch.from_numpy(cesm_data()).to(dev)),
             ("256^3", lambda: torch.from_numpy(cube_data()).to(dev)),
             ("512x512x2048", lambda: big_cube(dev)))
    launches_nd = {"encode_nd": 0, "decode_nd": 0}
    for label, make in cells:
        x = make()
        shape = tuple(x.shape)
        torch.cuda.synchronize()
        for k in codec_cuda.LAUNCHES:
            codec_cuda.LAUNCHES[k] = 0
        s, length = nt.compress_device(x)
        L = int(length)
        y = nt.decompress_device(s[:L], shape)
        torch.cuda.synchronize()
        counts = dict(codec_cuda.LAUNCHES)
        if counts["encode_nd"] == 0 or counts["decode_nd"] == 0:
            fail(f"{label}: the 2D/3D path did not launch every nd kernel: {counts}")
        for k in launches_nd:
            launches_nd[k] += counts[k]
        check_cell(x, s, L, y, label)
        print(f"[4 path nd] {label}: stream == plain ({L} words, ratio {L / x.numel():.4f}), "
              f"round trip bit-exact; launches {counts}", flush=True)
        del s, y
        rows, sl = time_cell(x, label)
        if label == "256^3":
            w = x.view(torch.int32)
            kernel_ms["encode_nd"] = (median_ms(lambda: codec_cuda._encode_interior_fp32(w)),
                                      rows["compress plain"])
            kernel_ms["decode_nd"] = (median_ms(lambda: codec_cuda._decode_interior_fp32(sl, shape)),
                                      rows["decompress plain"])
        del x, sl
        torch.cuda.empty_cache()
    launches.update(launches_nd)

    # ---- 4 and 5 for the fp64 path: bench.py's 1D 2^23 and 512^3 cells
    cells64 = (("fp64 2^23", lambda: torch.from_numpy(bench_data64(2**23)).to(dev)),
               ("fp64 512^3", lambda: cube64(dev)))
    for label, make in cells64:
        x = make()
        shape = tuple(x.shape)
        torch.cuda.synchronize()
        for k in codec_cuda.LAUNCHES:
            codec_cuda.LAUNCHES[k] = 0
        s, length = nt.compress_device(x)
        L = int(length)
        y = nt.decompress_device(s[:L], shape, torch.float64)
        torch.cuda.synchronize()
        counts = dict(codec_cuda.LAUNCHES)
        enc, dec = kernel_keys(x)
        if counts[enc] == 0 or counts[dec] == 0:
            fail(f"{label}: the fp64 path did not launch {enc} and {dec}: {counts}")
        launches[enc], launches[dec] = counts[enc], counts[dec]
        check_cell(x, s, L, y, label)
        print(f"[4 path fp64] {label}: stream == plain ({L} u32 words, ratio {L / (2 * x.numel()):.4f}), "
              f"round trip bit-exact; launches {counts}", flush=True)
        del s, y
        rows, sl = time_cell(x, label)
        w = x.view(torch.int64)
        if x.dim() == 1:
            kernel_ms[enc] = (median_ms(lambda: codec_cuda._encode_blocks_fp64(w)), rows["compress plain"])
            kernel_ms[dec] = (median_ms(lambda: codec_cuda._decode_blocks_fp64(sl, shape[0])),
                              rows["decompress plain"])
        else:
            kernel_ms[enc] = (median_ms(lambda: codec_cuda._encode_interior_fp64(w)), rows["compress plain"])
            kernel_ms[dec] = (median_ms(lambda: codec_cuda._decode_interior_fp64(sl, shape)),
                              rows["decompress plain"])
        del x, w, sl
        torch.cuda.empty_cache()

    if "jax" in sys.modules:
        fail("JAX was imported")
    sources = {"encode": ("encode_fp32", "ndzip_tpu_torch/csrc/encode_fp32.cu",
                          "ndzip_tpu/codec_pallas.py:778"),
               "decode": ("decode_fp32", "ndzip_tpu_torch/csrc/decode_fp32.cu",
                          "ndzip_tpu/codec_pallas.py:1248"),
               "encode_nd": ("encode_fp32_nd", "ndzip_tpu_torch/csrc/encode_fp32_nd.cu",
                             "ndzip_tpu/codec_pallas.py:944"),
               "decode_nd": ("decode_fp32_nd", "ndzip_tpu_torch/csrc/decode_fp32_nd.cu",
                             "ndzip_tpu/codec_pallas.py:1386"),
               "encode64": ("encode_fp64", "ndzip_tpu_torch/csrc/encode_fp64.cu",
                            "ndzip_tpu/codec_pallas.py:1575"),
               "decode64": ("decode_fp64", "ndzip_tpu_torch/csrc/decode_fp64.cu",
                            "ndzip_tpu/codec_pallas.py:1839"),
               "encode64_nd": ("encode_fp64_nd", "ndzip_tpu_torch/csrc/encode_fp64_nd.cu",
                               "ndzip_tpu/codec_pallas.py:1740"),
               "decode64_nd": ("decode_fp64_nd", "ndzip_tpu_torch/csrc/decode_fp64_nd.cu",
                               "ndzip_tpu/codec_pallas.py:1978")}
    kernels = [{"name": kname, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": err[k],
                "ms": kernel_ms[k][0], "plain_ms": kernel_ms[k][1]}
               for k, (kname, src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
