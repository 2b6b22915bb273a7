#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ndzip (``ndzip_tpu_torch``) once on one GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases, one
line each, and any failure raises and exits nonzero:

1. device: the card's name, ``nvidia-smi``'s name and power limit, versions;
2. build: the CUDA kernels from ``ndzip_tpu_torch/csrc`` with nvcc, one nvcc
   per source, all started together; what ``ptxas -v`` says of the 1D and the
   2D/3D fp32 kernels and of the three fp64 encoders (registers, shared
   memory, spills) and the CTAs an SM holds of each;
3. each kernel against its plain PyTorch version on the card, exact: the 1D
   kernels on small fp32 1D cases (borders, zeros, incompressible bits,
   constants, one block, special floats; the decoder also on the stream
   as a view at word offsets 1-3 of its storage, as ``stream[:length]`` with
   nothing after it, and truncated at four places, where it must not fault and
   must give what the plain version gives with zeros for the missing words;
   the encoder also 20 times in a row and six times on two CUDA streams at
   once, every stream equal to the plain version's), the 2D/3D kernels on small grids
   (aligned and unaligned rows, borders on one or two axes, constants, random
   bits, special floats; the same views, truncations, repeats and two CUDA
   streams as in 1D), one all-border grid through the glue, and two bordered
   grids through ``compress_device``/``decompress_device``: one whose border
   needs more CTAs than the card holds at once, one with unaligned rows and a
   border on every axis (the run must end, streams and round trips exact); then the
   four fp64 kernels on tests/test_pallas.py's fp64 shapes (an odd block
   count with the header's pad word, borders, 2D/3D) and on zeros, random
   64-bit words, a constant, special floats and one all-border grid; each
   decode reads the plain stream with -1 written past its length, and each
   encoder also runs 20 times in a row and six times on two CUDA streams;
4. the paths through the public entry points: ``compress_device`` then
   ``decompress_device(stream[:length], shape, dtype)``, fp32 1D at 2^24
   elements (bench.py's headline data) and 2^28 + 17, fp32 2D/3D at
   bench.py's CESM 1800x3600, 256^3 and 512x512x2048 (2 GiB) cells, then
   fp64 at bench.py's 1D 2^23 and 512^3 (1 GiB) cells and its 1D formula at
   2^27 + 17 (1 GiB, made on the card): streams equal to the
   plain version's on the card, bit-exact round trips, and the kernels'
   launch counts over each path, counted from 0 just before it. The tests
   hold the plain version's stream against the reference package byte for
   byte; this script imports nothing of that package;
5. timing with CUDA events: median of 10 runs after a warm-up, compress and
   decompress against the plain version and a device-to-device ``copy_``,
   per size and cell; then each kernel's mean device time per call from
   ``torch.profiler`` (a trace that holds fewer or more launches than REPS
   calls make, or a launch under half its kernel's median, is taken again,
   and ``[profile]`` says which check caught it; after three such traces the
   time is taken with CUDA events and the line says so); and for each of the eight
   codec kernels a ``[bound]``
   line: the bytes it must move at that size (input read once, output written
   once, the stream as long as this run's data makes it), the time the card's
   memory needs for them at ``HBM_BYTES_PER_S``, the kernel's device time and
   its share of that bound;
6. the entry points on the card: ``api.Offloader(..., "cuda",
   timing_mode="device")`` on the 2^24 fp32 and 2^23 fp64 cells (streams
   equal to the plain version's, bit-exact round trips, the cell's encode
   and decode kernels launched, counted from 0 just before, device times
   with the host's enqueue left out, each > 0, under the call's wall time
   and within DEVICE_TIMING_BAND of ``Offloader.measure``'s median, which
   may not exceed phase 5's event median),
   ``python -m ndzip_tpu_torch.cli -e cuda`` round trips through files on
   CESM 1800x3600 fp32 and a bordered fp64 3D grid (the .ndz files equal the
   plain version's streams, the outputs the inputs), and
   ``python -m ndzip_tpu_torch.warm`` on 2^24 and 1800x3600 in both dtypes,
   which must find the library phase 2 built;
7. ``ubench.stage_benchmarks`` at 64 MiB for fp32 in 1, 2 and 3 dims and fp64
   in 3, one line per stage with the card, with the stage kernels' launch
   counts over it, counted from 0 just before it; then each stage kernel
   against its plain version on ubench's working sets, exact, then timed
   (device times by CUDA events, see ``event_device_us``):
   P1 and P2 at 2^24 (4096 blocks), P3 at 256^3 and 4096x4096 fp32 and
   192^3 fp64 (scatters into grids of -1s), each with its ``[bound]`` line;
   P3 also against the one PyTorch call that computes the same function (a
   permuted view made contiguous, or copied into), which the port never calls.
8. the block-parallel layer (``parallel``): ``compress_sharded_device`` and
   ``decompress_sharded_device`` on four shards of the card (and across
   every card where more than one answers, else a line says that one card
   ran) for 2^28 + 17 fp32, fp64 512^3 and CESM 1800x3600, and on three
   shards for 512x512x2048 fp32: the stream equal to ``compress_device``'s,
   the round trip bit-exact, one encode and one decode launch a shard
   (counted from 0 just before the sharded calls) and CUDA-event medians
   beside the single-device calls; then ``parallel.multihost`` in two
   processes on the card over gloo, (2*4096, 4096) fp32 and
   (2*256, 256, 257) fp64: ``compress_to_file``'s file and
   ``gather_stream``'s stream equal to ``compress_device``'s and
   ``decompress_from_file``'s slabs the input's, each process with its own
   timeout; then ``dryrun_multichip(4)``;
9. the benchmark harness (``benchmark``): ``make_synthetic``'s five datasets
   at full size (BASELINE.json's set), each through ``benchmark_file`` with
   ``ndzip-cuda``, ``ndzip-cpu`` and ``memcpy``; the rows, not the exit code,
   decide: one ``ndzip-cuda`` row a dataset whose compressed bytes equal the
   plain version's stream on the card and ``ndzip-cpu``'s, the dataset's
   encode and decode kernel launched and no other codec kernel (counted from
   0 just before it), every time above 0; then ``plot_benchmark``'s table,
   the harness's device rep loop on ``sin1d.f32`` under
   ``utils.profiler_trace`` with ``utils.trace`` spans around its compress
   and decompress (both labels must be in the trace; its kernel records are
   printed, not gated), and ``examples/torch/02_device_resident.py`` on the
   card, which must print ``OK``.

Phase 3 also holds the five stage kernels of ``stages.py`` to their plain
versions, exact: the block gather and scatter on every 2D/3D case of both
dtypes (scatter into a grid of -1s, so untouched words show), the
placement stages on the whole blocks of the fp32 1D cases, and the keep
mask on dev/mosaic_repro.py's input, on random words and on the dense rows
of 8 blocks.

Before them a ``[done]`` line gives the script's wall time and the traces
taken again. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPS = 10
SEED = 0
DEVICE_TIMING_BAND = (0.8, 1.25)  # one Offloader device reading against measure()'s median
HBM_BYTES_PER_S = 3.35e12         # the H100 SXM's memory rate (NVIDIA's data sheet), what bounds every kernel here


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


def line32(dev, n: int):
    """bench_data's formula at n elements, made on the card with a
    torch.Generator seeded with SEED."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return (torch.sin(torch.arange(n, device=dev, dtype=torch.float32) * 1e-4)
            + 1e-3 * torch.randn(n, device=dev, generator=gen))


def bench_data64(n: int) -> np.ndarray:
    """bench.py's fp64 1D cell: sin(i * 1e-4) + 1e-3 * N(0, 1) in float64, seed 0."""
    rng = np.random.default_rng(SEED)
    return np.sin(np.arange(n, dtype=np.float64) * 1e-4) + 0.001 * rng.standard_normal(n)


def line64(dev, n: int):
    """bench_data64's formula at n elements, made on the card with a
    torch.Generator seeded with SEED."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return (torch.sin(torch.arange(n, dtype=torch.float64, device=dev) * 1e-4)
            + 1e-3 * torch.randn(n, dtype=torch.float64, device=dev, generator=gen))


def cube64(dev):
    """bench.py's fp64 512^3 cell (1 GiB): sin(z) cos(y) sin(2x) + 1e-3 * N(0, 1)
    in float64, made on the card with a torch.Generator seeded with SEED."""
    import torch

    z = torch.linspace(0, 9.0, 512, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d = torch.sin(z[:, None, None]) * torch.cos(z[None, :, None]) * torch.sin(2 * z[None, None, :])
    return d + 1e-3 * torch.randn((512, 512, 512), dtype=torch.float64, device=dev, generator=gen)


#: traces that device_us and flushed_and_warm took again, by the check that caught them, and the traces
#: whose one-call step came back empty
RETAKES = {"no device activity": 0, "fewer or more launches": 0, "a launch under half its kernel's median": 0,
           "flushed and back to back apart by more than AGREE": 0}
EMPTY_ONE_CALL = {"traces": 0}
#: device times that fell back to CUDA events after three failed traces or trace pairs
BY_EVENTS = {"device_us": 0, "flushed_and_warm": 0}
AGREE = 0.6  # least ratio of the flushed and the back-to-back device time of one function
PAD_CYCLES = 40_000_000    # a spin kernel of about 20 ms on an H100 (1.98 GHz), on either side of traced calls
LEAD_CYCLES = 200_000_000  # about 100 ms of spin that opens a trace's first recorded step


def traced_launches(fn, flush=None) -> tuple[dict[str, list[float]], dict[str, list[float]]]:
    """The device time in us of each launch of each kernel that one call of
    ``fn`` and REPS calls make under torch.profiler, by the kernel's name;
    with ``flush`` run before each of the REPS calls and its kernels left out.

    Traces lost records of short kernels late in the run: those that ran in
    the first 20 ms or so of device time after the profiler's warm-up step
    (a lone call there, or one to four of ten behind a 20 ms spin), and a
    few at a trace's end without device work after them. So one profiler
    session holds a warm-up call that the profiler traces and drops (the
    schedule's ``warmup``), a step that opens with a spin of about 100 ms
    (LEAD_CYCLES) and holds the REPS calls, and a step with the one call,
    each call group between spins of about 20 ms (PAD_CYCLES); the spins are
    left out like the flush. The one call's launches are those that start
    after the last step does: the spins keep the split 40 ms from either
    group, wider than the skews seen between the card's and the host's
    timestamps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    skip = getattr(flush, "keys", ())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda._sleep(PAD_CYCLES)
        for _ in range(REPS):
            if flush:
                flush()
            fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(PAD_CYCLES)
        fn()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        prof.step()
    events = prof.events()
    last_step = max(e.time_range.start for e in events
                    if e.device_type.name == "CPU" and e.name.startswith("ProfilerStep"))
    one, calls = {}, {}
    for e in events:  # kernels and copies; the step annotations and the spins are not the function's
        if (e.device_type.name == "CUDA" and e.key not in skip and not e.key.startswith("ProfilerStep")
                and "spin_kernel" not in e.key):
            (one if e.time_range.start >= last_step else calls).setdefault(e.key, []).append(e.device_time_total)
    return one, calls


def device_us(fn, flush=None) -> tuple[float, str]:
    """Mean device time per call of what ``fn`` launches, from torch.profiler
    over REPS calls (the profiler's cost is inside): the sum in us, and the
    breakdown by kernel as text. With ``flush`` (see ``l2_flush``) that runs
    before every call, so that ``fn`` finds none of its bytes in the L2, and
    the flush's own kernels are left out of the sum.

    A trace can come back without device activity or with part of it, so
    each is checked and taken again if it fails: it must hold every kernel
    that one call launches (one call traced just after the REPS calls, in
    the same session) REPS times that often, and no launch of a kernel may
    take under half the median of its kernel's launches. The lone call's
    step can come back empty (``traced_launches``); each kernel's count must
    then be a whole multiple of REPS, and ``EMPTY_ONE_CALL`` counts it. ``RETAKES`` counts what each check
    caught. After three failed traces in a row no trace is averaged: the
    time is ``event_device_us``'s, the text says so, and ``BY_EVENTS``
    counts it."""
    import statistics

    for _attempt in range(3):
        one, launches = traced_launches(fn, flush)
        one = {key: len(us) for key, us in one.items()}
        counts = {key: len(us) for key, us in launches.items()}
        if launches and not one:
            EMPTY_ONE_CALL["traces"] += 1
        if not launches:
            why = "no device activity"
        elif (counts != {key: REPS * n for key, n in one.items()} if one
              else any(n % REPS for n in counts.values())):
            why = "fewer or more launches"
        elif any(min(us) < 0.5 * statistics.median(us) for us in launches.values()):
            why = "a launch under half its kernel's median"
        else:
            rows = sorted(((sum(us) / REPS, key.split("(")[0]) for key, us in launches.items()), reverse=True)
            return sum(us for us, _ in rows), "; ".join(f"{key} {us:.2f}" for us, key in rows)
        RETAKES[why] += 1
        print(f"[profile] trace taken again: {why} (one call {one}, {REPS} calls {counts})", flush=True)
    us = event_device_us(fn, flush)
    BY_EVENTS["device_us"] += 1
    print(f"[profile] no whole trace in three: device time {us:.2f} us by CUDA events", flush=True)
    return us, f"by CUDA events (no whole trace in three) {us:.2f}"


def event_device_us(fn, flush=None) -> float:
    """Mean device time in us per call of ``fn`` by CUDA events, which lose
    nothing: REPS calls queued behind a spin of about 20 ms (PAD_CYCLES), so
    that the host has queued them all before the card reaches the first,
    each call alone between two events and ``flush`` before it, outside
    them. Unlike a trace it counts each call's two events, the card's start
    of its launches and the gaps between them: on phase 7's stage kernels
    it read 8-16 us more than the profiler had (PERF.md)."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda.synchronize()
    torch.cuda._sleep(PAD_CYCLES)
    for start, end in pairs:
        if flush:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / REPS * 1e3


def flushed_and_warm(fn, flush, traced=True) -> tuple[float, str, float]:
    """``device_us`` of ``fn`` with the L2 flushed before every call (the sum
    and its text) and back to back (the sum). A trace whose launches are all
    cut short passes device_us's checks, so the two are held to each other:
    they differ by the L2 alone (at most a quarter at 64 MiB), and where one
    is under AGREE times the other both are taken again; after three such
    pairs in a row, and with ``traced`` false from the start, both are
    ``event_device_us``'s."""
    for _attempt in range(3 if traced else 0):
        us, parts = device_us(fn, flush)
        warm_us = device_us(fn)[0]
        if min(us, warm_us) >= AGREE * max(us, warm_us):
            return us, parts, warm_us
        RETAKES["flushed and back to back apart by more than AGREE"] += 1
        print(f"[profile] traces taken again: flushed {us:.2f} us and back to back {warm_us:.2f} us ({parts})",
              flush=True)
    if traced:
        BY_EVENTS["flushed_and_warm"] += 1
    us = event_device_us(fn, flush)
    return us, f"by CUDA events {us:.2f}", event_device_us(fn)


def l2_flush(dev):
    """A call that pushes everything out of the card's L2 (50 MB on the H100):
    it rewrites 256 MiB of scratch in place with ``cos_``, an operation that
    nothing timed here launches. ``keys`` holds the profiler's names of its
    kernels, read from a trace of the flush alone."""
    import torch

    scratch = torch.zeros(64 * 2**20, dtype=torch.float32, device=dev)

    def flush():
        scratch.cos_()

    flush.keys = set(traced_launches(flush)[1])
    if not flush.keys:
        fail("torch.profiler gave no device activity for the L2 flush")
    return flush


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


def grid_normal(rng, shape) -> np.ndarray:
    """Normal values on a grid with a run of zeros and a repeated run."""
    d = rng.standard_normal(shape).astype(np.float32)
    d.reshape(-1)[:200] = 0
    d.reshape(-1)[300:340] = d.reshape(-1)[299]
    return d


def nd_border_shapes() -> dict[str, tuple]:
    """Bordered 3D grids that go through the entry points: one whose border
    (4 Mi words, 1024 border CTAs beside 4096 blocks) needs more CTAs than an
    H100 holds at once (6 x 132), so an encoder whose border CTAs could start
    before its block CTAs would hang on it; and one with an odd minor extent
    (rows not 16-byte aligned) and a border on every axis."""
    return {"3d large border (20,1024,1024)": (20, 1024, 1024),
            "3d odd minor extent, border on every axis (37,150,1001)": (37, 150, 1001)}


def nd_kernel_cases() -> dict[str, np.ndarray]:
    """Small 2D/3D grids for the nd kernels: tests/test_pallas.py's shapes
    (rows 16-byte aligned or not, borders on none, one or two axes),
    constants, random bits, special floats, and one all-border grid."""
    rng = np.random.default_rng(SEED)

    def normal(shape):
        return grid_normal(rng, shape)

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


#: phase 8's two-process grids: (shape, dtype), each process's slab half of axis 0
MULTIHOST_CASES = {"fp32 (2*4096, 4096)": ((2 * 4096, 4096), "float32"),
                   "fp64 (2*256, 256, 257)": ((2 * 256, 256, 257), "float64")}
MULTIHOST_TIMEOUT = 180  # seconds for each of the two processes

#: one process of phase 8's gloo pair: argv = rank, port, scratch directory, repository root
MULTIHOST_WORKER = """
import sys, time
rank, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
import numpy as np, torch
import torch.distributed as dist
import chip_smoke
from ndzip_tpu_torch import compress_device
from ndzip_tpu_torch.parallel import multihost

multihost.init(f"localhost:{port}", 2, rank)
dev = torch.device("cuda", 0)
for i, (label, (shape, dtype)) in enumerate(chip_smoke.MULTIHOST_CASES.items()):
    full = chip_smoke.multihost_grid(label, dev)
    rows = full.shape[0] // 2
    slab = full[rank * rows: (rank + 1) * rows]
    want = slab.cpu().numpy().tobytes()
    path = f"{tmp}/{i}.ndz"
    t0 = time.perf_counter()
    total = multihost.compress_to_file(slab, path)
    t1 = time.perf_counter()
    got = multihost.decompress_from_file(path, shape, dtype)
    t2 = time.perf_counter()
    if got.tobytes() != want:
        raise SystemExit(f"{label}, process {rank}: decompress_from_file's slab != the input's")
    stream = multihost.gather_stream(multihost.compress_multihost(slab))
    if rank == 0:
        ref, length = compress_device(full)
        ref = ref[: int(length)].cpu().numpy().tobytes()
        if stream.tobytes() != ref:
            raise SystemExit(f"{label}: gather_stream's stream != compress_device's")
        with open(path, "rb") as f:
            if f.read() != ref:
                raise SystemExit(f"{label}: compress_to_file's file != compress_device's stream")
    elif stream is not None:
        raise SystemExit("gather_stream returned a stream on process 1")
    print(f"[8 multihost] {label}, process {rank} of 2 on cuda:0 over gloo: compress_to_file {total} u32 words "
          f"in {t1 - t0:.3f} s, decompress_from_file slab == input in {t2 - t1:.3f} s, gather_stream "
          + ("== compress_device's stream == the file" if rank == 0 else "sent"), flush=True)
dist.destroy_process_group()
"""


def multihost_grid(label: str, dev):
    """Phase 8's two-process grid: sin(i * 1e-4) + 1e-3 * N(0, 1), made on
    the card with a torch.Generator seeded with SEED."""
    import torch

    shape, dtype = MULTIHOST_CASES[label]
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    i = torch.arange(math.prod(shape), dtype=dtype, device=dev).reshape(shape)
    return torch.sin(i * 1e-4) + 1e-3 * torch.randn(shape, dtype=dtype, device=dev, generator=gen)


def sharded_phase(dev, card: str):
    """Phase 8: ``parallel.compress_sharded_device`` and
    ``decompress_sharded_device`` on 4 shards of ``dev`` (and across every
    card where more than one answers) for 2^28 + 17 fp32, fp64 512^3 and CESM
    1800x3600, and on 3 shards for 512x512x2048 fp32: the stream equal to
    ``compress_device``'s, the round trip bit-exact, one encode and one
    decode launch a shard (counted from 0 just before the sharded calls),
    and CUDA-event medians beside the single-device calls; then the
    multihost layer in two processes on ``dev`` over gloo, and
    ``dryrun_multichip(4)``."""
    import socket

    import torch

    import ndzip_tpu_torch as nt
    from ndzip_tpu_torch import codec_cuda, codec_torch, parallel, utils
    from ndzip_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    meshes = [(f"4 shards on {dev}", [dev] * 4)]
    if n_cards > 1:
        meshes.append((f"{n_cards} shards on cuda:0..{n_cards - 1}", [torch.device("cuda", i) for i in range(n_cards)]))
    else:
        print("[8 sharded] one card answers: every shard ran on cuda:0; across cards not run", flush=True)
    grids = [("2^28+17", lambda: line32(dev, 2**28 + 17), meshes),
             ("fp64 512^3", lambda: cube64(dev), meshes),
             ("CESM 1800x3600", lambda: torch.from_numpy(cesm_data()).to(dev), meshes),
             ("512x512x2048", lambda: big_cube(dev), [(f"3 shards on {dev}", [dev] * 3)])]
    for label, make, grid_meshes in grids:
        x = make()
        shape = tuple(x.shape)
        suffix = ("64" if x.element_size() == 8 else "") + ("_nd" if x.dim() > 1 else "")
        ref, length = nt.compress_device(x)
        ref = ref[: int(length)]
        for what, mesh in grid_meshes:
            shards = sum(r0 < r1 for r0, r1 in sharded._shard_grid(shape, len(mesh)))
            torch.cuda.synchronize()
            for k in codec_cuda.LAUNCHES:
                codec_cuda.LAUNCHES[k] = 0
            s, ls = parallel.compress_sharded_device(x, mesh)
            L = int(ls)
            slabs = parallel.decompress_sharded_device(s[:L], shape, x.dtype, mesh)
            y = torch.cat([t.to(dev) for t in slabs])
            torch.cuda.synchronize()
            counts = {k: v for k, v in codec_cuda.LAUNCHES.items() if v}
            if counts != {"encode" + suffix: shards, "decode" + suffix: shards}:
                fail(f"[8 sharded] {label} on {what}: launches {counts}, not one encode{suffix} and one "
                     f"decode{suffix} for each of {shards} shards")
            if L != ref.numel() or not torch.equal(s[:L], ref):
                fail(f"[8 sharded] {label} on {what}: stream != compress_device's")
            if not torch.equal(codec_torch.as_words(y), codec_torch.as_words(x)):
                fail(f"[8 sharded] {label} on {what}: round trip is not bit-exact")
            del s, slabs, y
            ms = {"compress_device": utils.device_time_ms(lambda: nt.compress_device(x), REPS),
                  "compress_sharded_device": utils.device_time_ms(
                      lambda: parallel.compress_sharded_device(x, mesh), REPS),
                  "decompress_device": utils.device_time_ms(
                      lambda: nt.decompress_device(ref, shape, x.dtype), REPS),
                  "decompress_sharded_device": utils.device_time_ms(
                      lambda: parallel.decompress_sharded_device(ref, shape, x.dtype, mesh), REPS)}
            print(f"[8 sharded] {label} ({x.numel() * x.element_size() / 2**20:.1f} MiB) on {what}: stream == "
                  f"compress_device's ({L} u32 words), round trip bit-exact, launches {counts}; CUDA-event "
                  f"medians of {REPS} (host gaps and the sharded paths' one host sync in): "
                  f"compress_device {ms['compress_device']:.4f} ms, compress_sharded_device "
                  f"{ms['compress_sharded_device']:.4f} ms ({ms['compress_sharded_device'] / ms['compress_device']:.3f}x), "
                  f"decompress_device {ms['decompress_device']:.4f} ms, decompress_sharded_device "
                  f"{ms['decompress_sharded_device']:.4f} ms "
                  f"({ms['decompress_sharded_device'] / ms['decompress_device']:.3f}x) on {card}", flush=True)
        del x, ref
        torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent
    with socket.socket() as sock:  # a free port for the process group
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "worker.py"
        script.write_text(MULTIHOST_WORKER)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(script), str(rank), port, tmp, str(root)], cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MULTIHOST_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            fail(f"[8 multihost] a process did not end within {MULTIHOST_TIMEOUT} s")
        for rank, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode or out.count("[8 multihost]") != len(MULTIHOST_CASES):
                fail(f"[8 multihost] process {rank} exited {p.returncode}:\n{out[-3000:]}")
            print("\n".join(line for line in out.splitlines() if line.startswith("[8 multihost]")), flush=True)
        print(f"[8 multihost] two processes on cuda:0 over gloo, both grids, in {time.perf_counter() - t0:.1f} s "
              f"of wall time", flush=True)

    t0 = time.perf_counter()
    parallel.dryrun_multichip(4)
    print(f"[8 dryrun] dryrun_multichip(4) on {n_cards} card(s): the four host cases and the device-resident "
          f"case equal golden.compress, round trips bit-exact, in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[8 done] phase 8 took {time.perf_counter() - t_phase:.1f} s of wall time", flush=True)


#: phase 9's datasets (``benchmark.make_synthetic``) and the two codec kernels each must launch,
#: by their keys in ``codec_cuda.LAUNCHES``
HARNESS_KERNELS = {"sin1d.f32": ("encode", "decode"), "grid2d.f32": ("encode_nd", "decode_nd"),
                   "cube3d.f64": ("encode64_nd", "decode64_nd"), "walk1d.f64": ("encode64", "decode64"),
                   "sparse3d.f32": ("encode_nd", "decode_nd")}
HARNESS_ALGORITHMS = ("memcpy", "ndzip-cpu", "ndzip-cuda")
HARNESS_REPS = (3, 5)  # min_reps, max_reps of phase 9's harness calls, at min_time 0
EXAMPLE_TIMEOUT = 300  # seconds for examples/torch/02_device_resident.py


def harness_phase(dev, card: str):
    """Phase 9: the benchmark harness on the card. ``make_synthetic``'s five
    datasets, each through ``benchmark_file`` with ``HARNESS_ALGORITHMS``;
    ``benchmark_file`` reports a failed algorithm on a ``#`` line and goes
    on, as the reference does, so the rows are checked: one ``ndzip-cuda``
    row, its compressed bytes equal to the plain version's stream on the card
    and to ``ndzip-cpu``'s, the dataset's two kernels of ``HARNESS_KERNELS``
    launched and no other, every time above 0; and ``compress_device``'s
    stream is held to the plain version's word for word. Then ``plot_benchmark``'s
    table, a profiler trace of the harness's device rep loop on
    ``sin1d.f32`` with ``utils.trace`` spans, and the device-resident
    walkthrough on the card."""
    import io
    import statistics

    import torch

    from ndzip_tpu_torch import benchmark, codec_cuda, codec_torch, interop, plot_benchmark, utils

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datasets = benchmark.make_synthetic(Path(tmp) / "data")
        if [d.name for d in datasets] != list(HARNESS_KERNELS):
            fail(f"[9 harness] make_synthetic gave {[d.name for d in datasets]}, not {list(HARNESS_KERNELS)}")
        print(f"[9 harness] make_synthetic: {len(datasets)} datasets, "
              f"{sum(d.path.stat().st_size for d in datasets) / 2**20:.1f} MiB, in {time.perf_counter() - t0:.1f} s",
              flush=True)
        algos = {k: v for k, v in benchmark.default_algorithms().items() if k in HARNESS_ALGORITHMS}
        csv = benchmark.CSV_HEADER + "\n"
        for ds in datasets:
            torch.cuda.synchronize()
            for k in codec_cuda.LAUNCHES:
                codec_cuda.LAUNCHES[k] = 0
            out = io.StringIO()
            benchmark.benchmark_file(ds, algos, [1], 0.0, *HARNESS_REPS, out=out)
            torch.cuda.synchronize()
            counts = {k: v for k, v in codec_cuda.LAUNCHES.items() if v}
            csv += out.getvalue()
            rows = plot_benchmark.read_rows(io.StringIO(benchmark.CSV_HEADER + "\n" + out.getvalue()))
            cuda_rows = [r for r in rows if r.algorithm == "ndzip-cuda"]
            if len(cuda_rows) != 1:
                fail(f"[9 harness] {ds.name}: {len(cuda_rows)} ndzip-cuda rows, not 1 (a failed run prints a '#' "
                     f"line to stderr)")
            row = cuda_rows[0]
            # the kernels' stream, held word for word to the plain version's (these launches come after the
            # counts are read and are not counted)
            words = interop.words_from_numpy(ds.load(), dev)
            plain_stream, plain_length = codec_torch.encode(words)
            plain_length = int(plain_length)
            stream, length = codec_cuda.compress_device(words)
            same = int(length) == plain_length and torch.equal(stream[:plain_length], plain_stream[:plain_length])
            del words, plain_stream, stream
            if not same:
                fail(f"[9 harness] {ds.name}: codec_cuda.compress_device's stream differs from the plain version's")
            if row.compressed != plain_length * 4:
                fail(f"[9 harness] {ds.name}: ndzip-cuda's {row.compressed} compressed bytes != the plain "
                     f"version's {plain_length * 4}")
            cpu_rows = [r for r in rows if r.algorithm == "ndzip-cpu"]
            if any(r.compressed != row.compressed for r in cpu_rows):
                fail(f"[9 harness] {ds.name}: ndzip-cpu's compressed bytes {[r.compressed for r in cpu_rows]} != "
                     f"ndzip-cuda's {row.compressed}")
            want = HARNESS_KERNELS[ds.name]
            if set(counts) != set(want):
                fail(f"[9 harness] {ds.name}: launches {counts}, not {' and '.join(want)} alone")
            if any(t <= 0 for r in rows for t in r.comp_times + r.decomp_times):
                fail(f"[9 harness] {ds.name}: a time of 0 in {out.getvalue()}")
            comp_ms = statistics.median(row.comp_times) * 1e3
            dec_ms = statistics.median(row.decomp_times) * 1e3
            others = "; ".join(f"{r.algorithm} {statistics.median(r.comp_times) * 1e3:.4f} / "
                               f"{statistics.median(r.decomp_times) * 1e3:.4f} ms" for r in rows if r is not row)
            print(f"[9 harness] {ds.name} {ds.shape} {ds.dtype.name}: ndzip-cuda compress "
                  f"{comp_ms:.4f} ms ({row.uncompressed / comp_ms / 1e6:.2f} GB/s), decompress {dec_ms:.4f} ms "
                  f"({row.uncompressed / dec_ms / 1e6:.2f} GB/s), medians of {len(row.comp_times)} and "
                  f"{len(row.decomp_times)} device times; ratio {row.ratio:.4f}, {row.compressed} bytes, the stream "
                  f"== the plain version's" + (" == ndzip-cpu's" if cpu_rows else " (ndzip-cpu did not run)")
                  + f"; launches {counts}; beside it (median compress / decompress, host clock): {others}; "
                  f"on {card}", flush=True)
            print("\n".join(f"[9 csv] {line}" for line in out.getvalue().strip().splitlines()), flush=True)
        table = io.StringIO()
        plot_benchmark.print_table(plot_benchmark.summarize(plot_benchmark.read_rows(io.StringIO(csv))), out=table)
        print("\n".join(f"[9 table] {line}" for line in table.getvalue().splitlines()), flush=True)

        sin = datasets[0]
        x = interop.words_from_numpy(sin.load(), dev)
        stream, length = codec_cuda.compress_device(x)
        s = stream[: int(length)]
        labels = ("ndzip-cuda compress sin1d.f32", "ndzip-cuda decompress sin1d.f32")
        trace_dir = Path(tmp) / "trace"
        with utils.profiler_trace(trace_dir):
            with utils.trace(labels[0]):
                comp = benchmark._device_rep_loop(lambda: codec_cuda.compress_device(x), 0.0, *HARNESS_REPS)
            with utils.trace(labels[1]):
                dec = benchmark._device_rep_loop(lambda: codec_cuda.decompress_device(s, sin.shape, x.dtype),
                                                 0.0, *HARNESS_REPS)
        files = list(trace_dir.glob("*.pt.trace.json"))
        if len(files) != 1:
            fail(f"[9 trace] profiler_trace wrote {len(files)} trace files, not 1")
        events = json.loads(files[0].read_text()).get("traceEvents", [])
        names = {e.get("name") for e in events}
        if not all(label in names for label in labels):
            fail(f"[9 trace] the trace lacks a span: {[label for label in labels if label not in names]}")
        kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                n, us = kernels.get(e["name"], (0, 0.0))
                kernels[e["name"]] = (n + 1, us + e.get("dur", 0))
        print(f"[9 trace] both spans in {files[0].name}; device reps {[round(t * 1e3, 4) for t in comp]} and "
              f"{[round(t * 1e3, 4) for t in dec]} ms; kernel records (not gated; the profiler loses records late "
              f"in a run): " + "; ".join(f"{k[:60]} x{n} {us:.1f} us" for k, (n, us) in sorted(kernels.items())),
              flush=True)
        del x, stream, s

    example = root / "examples" / "torch" / "02_device_resident.py"
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, str(example)], cwd=root, capture_output=True, text=True,
                             timeout=EXAMPLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"[9 example] {example.name} did not end within {EXAMPLE_TIMEOUT} s")
    lines = res.stdout.strip().splitlines()
    if res.returncode or not lines or lines[-1] != "OK":
        fail(f"[9 example] {example.name} exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    print("\n".join(f"[9 example] {line}" for line in lines), flush=True)
    print(f"[9 example] {example.name} on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[9 done] phase 9 took {time.perf_counter() - t_phase:.1f} s of wall time", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    started = time.perf_counter()

    import ndzip_tpu_torch as nt
    from ndzip_tpu_torch import _build, api, codec_cuda, codec_torch, stages, ubench, utils
    from ndzip_tpu_torch.codec_torch import HC

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    card = utils.card()  # nvidia-smi's name and power limit
    print(f"[1 device] {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"cards: {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.load()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for kernel, what, ctas in (
            ("5ndzip13encode_blocksE", "1D fp32 encode_blocks", lib.ndzip_encode_fp32_ctas_per_sm()),
            ("5ndzip13decode_blocksE", "1D fp32 decode_blocks", lib.ndzip_decode_fp32_ctas_per_sm()),
            ("5ndzip16encode_blocks_ndILi2E", "2D fp32 encode_blocks_nd", lib.ndzip_encode_fp32_nd_ctas_per_sm(2)),
            ("5ndzip16encode_blocks_ndILi3E", "3D fp32 encode_blocks_nd", lib.ndzip_encode_fp32_nd_ctas_per_sm(3)),
            ("5ndzip16decode_blocks_ndILi2E", "2D fp32 decode_blocks_nd", lib.ndzip_decode_fp32_nd_ctas_per_sm(2)),
            ("5ndzip16decode_blocks_ndILi3E", "3D fp32 decode_blocks_nd", lib.ndzip_decode_fp32_nd_ctas_per_sm(3)),
            ("5ndzip15encode_blocks64E", "1D fp64 encode_blocks64", lib.ndzip_encode_fp64_ctas_per_sm()),
            ("5ndzip18encode_blocks64_ndILi2E", "2D fp64 encode_blocks64_nd", lib.ndzip_encode_fp64_nd_ctas_per_sm(2)),
            ("5ndzip18encode_blocks64_ndILi3E", "3D fp64 encode_blocks64_nd", lib.ndzip_encode_fp64_nd_ctas_per_sm(3))):
        lines = _build.ptxas_lines(kernel)
        if len(lines) != 1 or ctas < 1:
            fail(f"ptxas reported the kernel {what} {len(lines)} times, or no CTA of it fits an SM ({ctas})")
        print(f"[2 build] ptxas -v, {what}: {lines[0].split(': ', 1)[1]}; {ctas} CTAs an SM", flush=True)

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
        if label == "all zeros" and int(lengths.max()) != HC // 32:
            fail("all zeros did not give every block the 128-word minimum")
        # the decoder on views of the stream: at odd word offsets of its storage, with nothing
        # after the stream, and truncated (no fault; the missing words count as zeros)
        for offset in (0, 1, 2, 3):
            storage = torch.full((offset + L,), -1, dtype=torch.int32, device=dev)
            storage[offset:] = ref_stream[:L]
            e = max_abs_err(codec_cuda._decode_blocks_fp32(storage[offset:], n), w)
            err["decode"] = max(err["decode"], e)
            if e:
                fail(f"decode kernel != input on {label!r}, stream[:length] at word offset {offset} of its "
                     f"storage (max_abs_err {e})")
        for cut in sorted({num_hc, num_hc + 1, num_hc + 130, L * 2 // 3, L - 1}):
            zeros_past = torch.zeros_like(ref_stream)
            zeros_past[:cut] = ref_stream[:cut]
            out = codec_cuda._decode_blocks_fp32(ref_stream[:cut].clone(), n)
            e = max_abs_err(out[: num_hc * HC], codec_torch.decode_blocks_ref(zeros_past, num_hc).reshape(-1))
            err["decode"] = max(err["decode"], e)
            if e:
                fail(f"decode kernel != plain on {label!r} truncated to {cut} of {L} words (max_abs_err {e})")
        # the encoder again and again, and on two CUDA streams at once: a call's status words are its own
        side = [torch.cuda.Stream(), torch.cuda.Stream()]
        torch.cuda.synchronize()
        again = [codec_cuda._encode_blocks_fp32(w) for _ in range(20)]
        for i in range(6):
            with torch.cuda.stream(side[i % 2]):
                again.append(codec_cuda._encode_blocks_fp32(w))
        torch.cuda.synchronize()
        for i, (stream, length) in enumerate(again):
            e = max_abs_err(stream[:L], ref_stream[:L]) if int(length) == L else -1
            err["encode"] = max(err["encode"], e)
            if e:
                fail(f"encode kernel != plain on {label!r}, call {i} of 20 in a row and 6 on two CUDA streams")
        del again
        print(f"[3 kernels] {label}: n={n} blocks={num_hc} length={L} encode == plain (26 more calls, 6 of them "
              f"on two CUDA streams), decode == plain == input (also at word offsets 1-3, without slack, and "
              f"truncated)", flush=True)

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
        # as in 1D: the decoder on views of the stream at any word offset of its storage, with
        # nothing after the stream, and truncated (no fault; the missing words count as zeros)
        for offset in (0, 1, 2, 3):
            storage = torch.full((offset + L,), -1, dtype=torch.int32, device=dev)
            storage[offset:] = ref_stream[:L]
            e = max_abs_err(codec_cuda._decode_interior_fp32(storage[offset:], shape), w)
            err["decode_nd"] = max(err["decode_nd"], e)
            if e:
                fail(f"nd decode kernel != input on {label!r}, stream[:length] at word offset {offset} of its "
                     f"storage (max_abs_err {e})")
        for cut in sorted({num_hc, num_hc + 1, num_hc + 130, L * 2 // 3, L - 1}):
            zeros_past = torch.zeros_like(ref_stream)
            zeros_past[:cut] = ref_stream[:cut]
            out = codec_cuda._decode_interior_fp32(ref_stream[:cut].clone(), shape)
            e = max_abs_err(codec_torch.gather_blocks(out, shape), codec_torch.decode_blocks_ref(zeros_past, num_hc, dims))
            err["decode_nd"] = max(err["decode_nd"], e)
            if e:
                fail(f"nd decode kernel != plain on {label!r} truncated to {cut} of {L} words (max_abs_err {e})")
        # the encoder again and again, and on two CUDA streams at once: a call's status words are its own
        side = [torch.cuda.Stream(), torch.cuda.Stream()]
        torch.cuda.synchronize()
        again = [codec_cuda._encode_interior_fp32(w) for _ in range(20)]
        for i in range(6):
            with torch.cuda.stream(side[i % 2]):
                again.append(codec_cuda._encode_interior_fp32(w))
        torch.cuda.synchronize()
        for i, (stream, length) in enumerate(again):
            e = max_abs_err(stream[:L], ref_stream[:L]) if int(length) == L else -1
            err["encode_nd"] = max(err["encode_nd"], e)
            if e:
                fail(f"nd encode kernel != plain on {label!r}, call {i} of 20 in a row and 6 on two CUDA streams")
        del again
        print(f"[3 kernels] {label}: blocks={num_hc} length={L} nd encode == plain (26 more calls, 6 of them on "
              f"two CUDA streams), nd decode == plain == input (also at word offsets 0-3 without slack, and "
              f"truncated)", flush=True)

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
        # the one-pass encoder again and again, and on two CUDA streams at once: a call's status
        # words are its own
        encode = codec_cuda._encode_blocks_fp64 if dims == 1 else codec_cuda._encode_interior_fp64
        side = [torch.cuda.Stream(), torch.cuda.Stream()]
        torch.cuda.synchronize()
        again = [encode(w) for _ in range(20)]
        for i in range(6):
            with torch.cuda.stream(side[i % 2]):
                again.append(encode(w))
        torch.cuda.synchronize()
        for i, (stream, length) in enumerate(again):
            e = max_abs_err(stream[:L], ref_stream[:L]) if int(length) == L else -1
            err[enc] = max(err[enc], e)
            if e:
                fail(f"fp64 encode kernel != plain on {label!r}, call {i} of 20 in a row and 6 on two CUDA streams")
        del again
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
        print(f"[3 kernels fp64] {label}: blocks={num_hc} length={L} u32 words, {enc} == plain (26 more calls, "
              f"6 of them on two CUDA streams), "
              f"{dec} == plain == input (0 differing words)", flush=True)

    # ---- 3, the stage kernels against their plain versions, exact
    serr = dict.fromkeys(stages.LAUNCHES, 0)

    def hold(key, kernel_out, plain_out, what):
        e = max_abs_err(kernel_out, plain_out)
        serr[key] = max(serr[key], e)
        if e:
            fail(f"stage kernel {key} != plain on {what} (max_abs_err {e})")

    grids = list(nd_kernel_cases().items())
    grids += [(f"fp64 {label}", data) for label, data in fp64_kernel_cases().items() if data.ndim > 1]
    for label, data in grids:
        w = cuda_words(data)
        shape, side = tuple(w.shape), {2: 64, 3: 16}[w.dim()]
        if math.prod(e // side for e in shape) == 0:
            continue  # all border: the stage kernels take grids with a whole block
        suffix = "64" if w.dtype == torch.int64 else ""
        blocks = codec_torch.gather_blocks(w, shape)
        hold("gather_blocks_nd" + suffix, stages.gather_blocks_nd(w), blocks, label)
        out, ref = torch.full_like(w, -1), torch.full_like(w, -1)
        stages.scatter_blocks_nd(blocks, out)
        codec_torch.scatter_blocks(blocks, shape, ref)
        hold("scatter_blocks_nd" + suffix, out, ref, label)
        print(f"[3 stages] {label}: {blocks.shape[0]} blocks, gather_blocks_nd{suffix} == plain, "
              f"scatter_blocks_nd{suffix} into -1s == plain", flush=True)
    for label, data in kernel_cases().items():
        w = cuda_words(data)
        blocks = w[: w.numel() // HC * HC].reshape(-1, HC)
        hold("placement_floor", stages.placement_floor(blocks), stages.placement_floor_ref(blocks), label)
        hold("placement_compute", stages.placement_compute(blocks), stages.placement_compute_ref(blocks), label)
        print(f"[3 stages] {label}: {blocks.shape[0]} blocks, placement_floor == plain, "
              f"placement_compute == plain", flush=True)
    rng = np.random.default_rng(SEED)
    masks = [("dev/mosaic_repro.py's ones",
              torch.ones((stages.P2_ROWS, stages.LANES), dtype=torch.int32, device=dev), stages.P2_LIMIT)]
    for fill in (0, 37, 128):
        x = rng.integers(-2**31, 2**31, (stages.P2_ROWS, stages.LANES), dtype=np.int64).astype(np.int32)
        x[rng.random(x.shape) < 0.5] = 0
        x[0, 0] = fill
        masks.append((f"random words, fill {fill}", torch.from_numpy(x).to(dev), stages.P2_LIMIT))
    blocks = cuda_words(kernel_cases()["4096*8"]).reshape(-1, HC)
    nb = blocks.shape[0]
    dense, valid, _ = codec_torch.encode_blocks_dense(blocks, 1)
    masks.append((f"[fill row; dense rows of {nb} blocks]", stages.staging(dense, 37), 1 + stages.ROWS * nb))
    for label, x, limit in masks:
        m = stages.keep_mask(x, limit)
        hold("keep_mask", m, stages.keep_mask_ref(x, limit), label)
        print(f"[3 stages] keep_mask on {label} ({x.shape[0]}x{x.shape[1]}, limit {limit}) == plain, "
              f"{int(m.sum())} words kept", flush=True)
    if not torch.equal(m[1:].reshape(nb, -1).bool(), valid):
        fail("keep_mask on the dense rows != encode_blocks_dense's valid")

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

    # ---- 3, bordered grids through the entry points: the run must end, and be exact
    for label, shape in nd_border_shapes().items():
        x = torch.from_numpy(grid_normal(np.random.default_rng(SEED), shape)).to(dev)
        num_hc = math.prod(e // 16 for e in shape)
        border_ctas = -(-(x.numel() - num_hc * HC) // HC)
        s, length = nt.compress_device(x)
        L = int(length)
        y = nt.decompress_device(s[:L], shape)
        torch.cuda.synchronize()
        check_cell(x, s, L, y, label)
        print(f"[3 kernels] {label}: blocks={num_hc}, {border_ctas} border CTAs, length={L}: stream == plain, "
              f"round trip bit-exact", flush=True)
        del x, s, y
    torch.cuda.empty_cache()

    # ---- 4. the fp32 1D path, through the public entry points
    n24, n28 = 2**24, 2**28 + 17
    x24 = torch.from_numpy(bench_data(n24)).to(dev)
    x28 = line32(dev, n28)
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
        return utils.device_time_ms(fn, REPS)

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
                  f"{device_us(fn)[1]} on {card}", flush=True)
        return rows, sl

    kernel_rows, event_ms = {}, {}  # event_ms: phase 5's rows of the cells phase 6 runs again

    flush = l2_flush(dev)

    def record(key, what, kernel, plain_ms, bytes_in, bytes_out, library=None, traced=True):
        """One kernel at one size: the wrapper's event median, its device time from the profiler
        with the L2 flushed before every call (and, beside it, back to back), and the least time
        the card's memory needs for the bytes the function must move (each input byte read once,
        each output byte written once). The share is bound / flushed device time: back to back a
        64 MiB input is served in part by the L2, which the bound does not know. The first size of
        a kernel goes to the JSON line. With ``traced`` false the device times are taken by CUDA
        events alone (``event_device_us``)."""
        ms = median_ms(kernel)
        us, parts, warm_us = flushed_and_warm(kernel, flush, traced)
        bound_ms = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
        library_ms = median_ms(library) if library else None
        if library:
            lib_us, _, lib_warm_us = flushed_and_warm(library, flush, traced)
        library_text = (f"{library_ms:.4f} ms (device {lib_us:.2f} us, back to back {lib_warm_us:.2f} us)"
                        if library else "none")
        share = bound_ms * 1e3 / us
        # a kernel ends when its stores reach the 50 MB L2, not the memory: at 64 MiB it can end
        # before the memory's rate allows, and the share is then not given
        share_text = f"{share:.1%}" if share <= 1 else (
            "not given: the device time is under the bound (the L2 still holds part of the output when "
            "the kernel ends), so the bytes at the memory's rate are no lower bound at this size")
        kernel_rows.setdefault(key, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                                     "library_ms": library_ms})
        print(f"[bound] {key} at {what}: {bytes_in / 1e6:.1f} + {bytes_out / 1e6:.1f} MB in + out, bound "
              f"{bound_ms * 1e3:.2f} us (bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); device {us:.2f} us "
              f"after an L2 flush ({parts}), {warm_us:.2f} us back to back; bound / device = {share_text}; "
              f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, library call {library_text} on {card}", flush=True)

    def record_codec(x, sl, rows, what):
        """The encode and decode kernels that take ``x``, at its size; ``sl`` is its stream."""
        w = codec_torch.as_words(x)
        shape, wide, nd = tuple(w.shape), w.element_size() == 8, w.dim() > 1
        enc, dec = kernel_keys(x)
        encode = {(False, False): codec_cuda._encode_blocks_fp32, (False, True): codec_cuda._encode_interior_fp32,
                  (True, False): codec_cuda._encode_blocks_fp64, (True, True): codec_cuda._encode_interior_fp64}
        decode = {(False, False): codec_cuda._decode_blocks_fp32, (False, True): codec_cuda._decode_interior_fp32,
                  (True, False): codec_cuda._decode_blocks_fp64, (True, True): codec_cuda._decode_interior_fp64}
        raw, packed = w.numel() * w.element_size(), sl.numel() * 4
        record(enc, what, lambda: encode[wide, nd](w), rows["compress plain"], raw, packed)
        record(dec, what, lambda: decode[wide, nd](sl, shape if nd else shape[0]), rows["decompress plain"],
               packed, raw)

    rows, sl = time_cell(x24, f"n={n24}")
    event_ms["2^24"] = rows
    record_codec(x24, sl, rows, "2^24")
    rows, sl = time_cell(x28, f"n={n28}")
    record_codec(x28, sl, rows, "2^28+17")
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
        if label != "CESM 1800x3600":
            record_codec(x, sl, rows, label)
        del x, sl
        torch.cuda.empty_cache()
    launches.update(launches_nd)

    # ---- 4 and 5 for the fp64 path: bench.py's 1D 2^23 and 512^3 cells, and its 1D formula at 1 GiB
    cells64 = (("fp64 2^23", lambda: torch.from_numpy(bench_data64(2**23)).to(dev)),
               ("fp64 2^27+17", lambda: line64(dev, 2**27 + 17)),
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
        event_ms[label] = rows
        record_codec(x, sl, rows, label)
        del x, sl
        torch.cuda.empty_cache()

    # ---- 6. the entry points on the card: Offloader, CLI, warm
    # Two calls each: the first after empty_cache() also pays the caching allocator's cudaMalloc.
    # Device timing leaves the host's time to enqueue out, so each reading must lie within
    # DEVICE_TIMING_BAND of measure()'s median of the same device time, and that median may not
    # exceed phase 5's event median, which adds the host's gaps between launches.
    for label, data in (("2^24", bench_data(n24)), ("fp64 2^23", bench_data64(2**23))):
        off = api.Offloader(data.dtype, data.ndim, "cuda", timing_mode="device")
        w = cuda_words(data)
        enc, dec = kernel_keys(w)
        ps, pl = codec_torch.encode(w)
        plain = ps[: int(pl)].cpu().numpy().tobytes()
        del ps, w
        wdt = np.uint32 if data.itemsize == 4 else np.uint64
        calls = []
        torch.cuda.synchronize()
        for k in codec_cuda.LAUNCHES:
            codec_cuda.LAUNCHES[k] = 0
        for _ in range(2):
            (s, words), wall_c = utils.wall_time_ns(lambda: off.compress(data))
            c_ns = off.timing.compress_ns
            out, wall_d = utils.wall_time_ns(lambda: off.decompress(s, data.shape))
            d_ns = off.timing.decompress_ns
            if s.tobytes() != plain:
                fail(f"Offloader {label}: stream != the plain version's")
            if not np.array_equal(out.view(wdt), data.view(wdt)):
                fail(f"Offloader {label}: round trip is not bit-exact")
            if not (0 < c_ns <= wall_c and 0 < d_ns <= wall_d):
                fail(f"Offloader {label}: kernel times {c_ns}, {d_ns} ns not in (0, wall {wall_c}, {wall_d} ns]")
            calls.append((c_ns, wall_c, d_ns, wall_d))
        counts = dict(codec_cuda.LAUNCHES)
        if counts[enc] == 0 or counts[dec] == 0:
            fail(f"Offloader {label} did not launch {enc} and {dec}: {counts}")
        rows = event_ms[label]
        med = off.measure(data, REPS)
        lo, hi = DEVICE_TIMING_BAND
        for c_ns, _, d_ns, _ in calls:
            if not (lo * med.compress_ns <= c_ns <= hi * med.compress_ns
                    and lo * med.decompress_ns <= d_ns <= hi * med.decompress_ns):
                fail(f"Offloader {label}: device times {c_ns}, {d_ns} ns not within {lo}-{hi} times "
                     f"measure()'s medians {med.compress_ns}, {med.decompress_ns} ns")
        if med.compress_ns > rows["compress"] * 1e6 or med.decompress_ns > rows["decompress"] * 1e6:
            fail(f"Offloader {label}: measure()'s medians {med.compress_ns}, {med.decompress_ns} ns exceed "
                 f"phase 5's event medians {rows['compress']:.4f}, {rows['decompress']:.4f} ms")
        print(f"[6 offloader] {label}: stream == plain ({words} words), round trip bit-exact, "
              f"launches {enc} {counts[enc]}, {dec} {counts[dec]}; device timing (host's enqueue left out), "
              + "; ".join(f"call {i + 1}: compress_ns {c} (wall {wc} ns), decompress_ns {d} (wall {wd} ns)"
                          for i, (c, wc, d, wd) in enumerate(calls))
              + f"; measure() medians of {REPS}: compress_ns {med.compress_ns}, decompress_ns "
              f"{med.decompress_ns}; phase 5 event medians (host gaps in) compress {rows['compress']:.4f} ms, "
              f"decompress {rows['decompress']:.4f} ms on {card}", flush=True)
        del out
    torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent
    lib_mtime = lib_path.stat().st_mtime_ns
    with tempfile.TemporaryDirectory() as tmp:
        cli_cases = []
        for i, (label, data) in enumerate((
                ("CESM 1800x3600", cesm_data()),
                ("fp64 3d border (17,32,129)", fp64_kernel_cases()["3d odd minor extent (17,32,129)"]))):
            raw, ndz, back = (Path(tmp) / f"{i}.{ext}" for ext in ("raw", "ndz", "back"))
            raw.write_bytes(data.tobytes())
            flags = ["-n", *map(str, data.shape), "-t", "float" if data.itemsize == 4 else "double", "-e", "cuda"]
            cli_cases.append((label, data, raw, ndz, back, flags))
        t0 = time.perf_counter()
        warm = subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.warm", "--shapes", "16777216", "1800x3600",
                               "--dtype", "float", "double"], cwd=root, capture_output=True, text=True, timeout=300)
        if warm.returncode or "found" not in warm.stderr or lib_path.name not in warm.stderr \
                or lib_path.stat().st_mtime_ns != lib_mtime:
            fail(f"warm exited {warm.returncode} or did not find the library {lib_path.name}:\n{warm.stderr}")
        print(f"[6 warm] exit 0, found {lib_path.name} (not rebuilt): "
              f"{' | '.join(warm.stderr.strip().splitlines())}", flush=True)
        for label, data, raw, ndz, back, flags in cli_cases:
            c, d = (subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.cli", *flags, *io], cwd=root,
                                   capture_output=True, text=True, timeout=300)
                    for io in (["-i", str(raw), "-o", str(ndz)], ["-d", "-i", str(ndz), "-o", str(back)]))
            if c.returncode or d.returncode:
                fail(f"cli -e cuda on {label} exited {c.returncode}, {d.returncode}:\n{c.stderr}\n{d.stderr}")
            ps, pl = codec_torch.encode(cuda_words(data))
            if ndz.read_bytes() != ps[: int(pl)].cpu().numpy().tobytes():
                fail(f"cli -e cuda on {label}: the .ndz file != the plain version's stream")
            if back.read_bytes() != raw.read_bytes():
                fail(f"cli -e cuda on {label}: the decompressed file != the input")
            print(f"[6 cli] {label}: .ndz == plain stream ({ndz.stat().st_size} bytes), decompressed == input; "
                  f"{c.stderr.strip()} | {d.stderr.strip()}", flush=True)
        print(f"[6 entry points] warm and the CLI round trips took {time.perf_counter() - t0:.1f} s of wall "
              f"time", flush=True)

    # ---- 7. ubench: every stage at 64 MiB; the stage kernels' launches counted over it
    for k in stages.LAUNCHES:
        stages.LAUNCHES[k] = 0
    for dims, dtype in ((1, "float"), (2, "float"), (3, "float"), (3, "double")):
        shape = ubench.working_shape(64, dims, dtype)
        for stage, nbytes, run in ubench.stage_benchmarks(shape, dims, dtype, dev):
            ms = run()
            print(f"[7 ubench] {dims}D {dtype} {shape} {stage}: {ms:.4f} ms/rep, "
                  f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s on {card}", flush=True)
    torch.cuda.synchronize()
    stage_launches = dict(stages.LAUNCHES)
    if not all(stage_launches.values()):
        fail(f"ubench did not launch every stage kernel: {stage_launches}")
    print(f"[7 ubench] stage kernel launches {stage_launches}", flush=True)
    torch.cuda.empty_cache()

    # each stage kernel against its plain version on ubench's working sets: exact (scatters into
    # grids of -1s, so that untouched words show), then timed with CUDA events, median of REPS.
    # The JSON line takes P1/P2 at 2^24 and P3 at 256^3 fp32 and 192^3 fp64.
    b24 = cuda_words(ubench.stage_data(ubench.working_shape(64, 1))).reshape(-1, HC)
    staged, limit = stages.staging(stages.placement_compute_ref(b24)), 1 + stages.ROWS * b24.shape[0]
    # (key, size, kernel, plain version, bytes in, bytes out, the one PyTorch call that does the same or None)
    nb24, dense_words = b24.shape[0], HC + HC // 32
    # the floor's function needs a block's first 2688 words; its kernel stages all 4096
    timed = [("placement_floor", "2^24", lambda: stages.placement_floor(b24),
              lambda: stages.placement_floor_ref(b24), nb24 * (stages.FLOOR - stages.HEADS) * 4,
              nb24 * stages.FLOOR * 4, None),
             ("placement_compute", "2^24", lambda: stages.placement_compute(b24),
              lambda: stages.placement_compute_ref(b24), b24.numel() * 4, nb24 * dense_words * 4, None),
             ("keep_mask", f"the 2^24 dense rows {tuple(staged.shape)}", lambda: stages.keep_mask(staged, limit),
              lambda: stages.keep_mask_ref(staged, limit), staged.numel() * 4, staged.numel() * 4, None)]
    for dims, dtype in ((3, "float"), (2, "float"), (3, "double")):
        g = cuda_words(ubench.stage_data(ubench.working_shape(64, dims, dtype), dtype))
        blocks, yard = codec_torch.gather_blocks(g, g.shape), torch.empty_like(g)
        out_k, out_p = torch.full_like(g, -1), torch.full_like(g, -1)
        suffix, what = ("64" if dtype == "double" else ""), f"{'x'.join(map(str, g.shape))} {g.dtype}"
        # events only: the profiler loses most of a device-to-device memcpy's records
        print(f"[7 stage vs plain] copy_ at {what} (the yardstick): {median_ms(lambda: yard.copy_(g)):.4f} ms "
              f"(median of {REPS}) on {card}", flush=True)
        # the library call: the grid as (blocks per axis, side) pairs, blocks' axes moved to the front
        side, nbytes = {2: 64, 3: 16}[dims], g.numel() * g.element_size()
        split = [e for extent in g.shape for e in (extent // side, side)]
        perm = list(range(0, 2 * dims, 2)) + list(range(1, 2 * dims, 2))
        out_l = torch.empty_like(g)

        def library_gather(g=g, split=split, perm=perm):
            return g.view(split).permute(perm).contiguous()

        def library_scatter(b=blocks, o=out_l, split=split, perm=perm):
            return o.view(split).permute(perm).copy_(b.view([split[i] for i in perm]))

        library_scatter()
        if max_abs_err(library_gather().reshape(-1, HC), blocks) or max_abs_err(out_l, g):
            fail(f"the library calls beside the block moves at {what} != plain")
        timed += [(f"gather_blocks_nd{suffix}", what, lambda g=g: stages.gather_blocks_nd(g),
                   lambda g=g: codec_torch.gather_blocks(g, g.shape), nbytes, nbytes, library_gather),
                  (f"scatter_blocks_nd{suffix}", what, lambda b=blocks, o=out_k: (stages.scatter_blocks_nd(b, o), o)[1],
                   lambda b=blocks, o=out_p: (codec_torch.scatter_blocks(b, o.shape, o), o)[1], nbytes, nbytes,
                   library_scatter)]
    # device times by CUDA events: late in a run torch.profiler lost records of these short kernels in
    # trace after trace, whatever spins and steps stood around the calls (PERF.md)
    for key, what, kernel, plain, bytes_in, bytes_out, library in timed:
        hold(key, kernel(), plain(), f"{what} (phase 7)")
        record(key, what, kernel, median_ms(plain), bytes_in, bytes_out, library, traced=False)

    # ---- 8. the block-parallel layer: sharded paths, two processes over gloo, the dry run
    sharded_phase(dev, card)

    # ---- 9. the benchmark harness: the synthetic datasets, the CSV's rows, a profiler trace, a walkthrough
    harness_phase(dev, card)

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
                "launches": launches[k], "max_abs_err": err[k], **kernel_rows[k]}
               for k, (kname, src, rep) in sources.items()]
    stage_sources = {"placement_floor": ("stage_placement.cu", "dev/enc_floor_probe.py:100"),
                     "placement_compute": ("stage_placement.cu", "dev/enc_floor_probe.py:100"),
                     "keep_mask": ("stage_keep_mask.cu", "dev/mosaic_repro.py:39"),
                     "gather_blocks_nd": ("stage_blocks_nd.cu", "dev/tile_xpose_probe.py:67"),
                     "scatter_blocks_nd": ("stage_blocks_nd.cu", "dev/tile_xpose_probe.py:67"),
                     "gather_blocks_nd64": ("stage_blocks_nd.cu", "dev/tile_xpose_probe.py:67"),
                     "scatter_blocks_nd64": ("stage_blocks_nd.cu", "dev/tile_xpose_probe.py:67")}
    kernels += [{"name": k, "route": "cuda", "source": f"ndzip_tpu_torch/csrc/{src}", "replaces": rep,
                 "launches": stage_launches[k], "max_abs_err": serr[k], **kernel_rows[k]}
                for k, (src, rep) in stage_sources.items()]
    print(f"[done] every phase passed in {time.perf_counter() - started:.1f} s of wall time; profiler traces "
          f"taken again: {RETAKES}; traces whose one-call step came back empty: {EMPTY_ONE_CALL['traces']}; "
          f"device times by CUDA events after three failed traces: {BY_EVENTS}",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
