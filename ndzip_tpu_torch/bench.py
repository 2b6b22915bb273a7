"""The port's headline benchmark: ``python -m ndzip_tpu_torch.bench``.

The counterpart of the repository's ``bench.py``, on one NVIDIA GPU. It runs
bench.py's cells on bench.py's data through ``compress_device`` and
``decompress_device`` and prints ONE JSON line, last on stdout:

  {"metric": METRIC, "value": N, "unit": "GB/s", "vs_baseline": N, "extra": {...}}

``value`` is the decompress throughput of 2^24 fp32 in 1D (uncompressed bytes
over the median device time), ``vs_baseline`` that throughput over a
device-to-device ``copy_`` of the same 64 MiB on the same card.

Cells (``CELLS``; ``FULL_CELLS`` too with ``NDZIP_TORCH_BENCH_FULL=1``), one
data function each, all drawing from one ``np.random.default_rng(0)`` in
bench.py's order with its formulas and dtypes (bench.py:150-153, :284-328),
so that the ratios equal bench.py's: ``fp32_1d`` (2^24 fp32, the headline),
``fp64`` (2^23 fp64), ``cesm`` (1800x3600 fp32), ``cube3d`` (256^3 fp32),
``fp64_512cube`` (512^3 fp64, 1 GiB) and ``fp32_2gib_3d`` (512x512x2048
fp32, 2 GiB; the FULL cells need 4-8 GiB of host memory for their float64
temporaries).

Timing: each of ``compress_device(x)``, ``decompress_device(stream[:length],
shape, dtype)`` and ``copy_`` of the same bytes between two CUDA events, its
launches queued behind a spin kernel so that the events hold the device's
time alone (``utils.device_time_ms(..., queued=True)``), median of ``REPS``
after ``WARMUP`` warm-ups. The ratio is the stream's length in the profile's
words times the word's bytes over the input's bytes (bench.py:266, :337).

Gates, on every cell before it is timed: a bit-exact round trip on the card,
and the stream equal byte for byte to the port's ``golden.compress`` stream
(the default cells) or to the plain version's (``codec_torch``) on the card
(the FULL cells, where golden is slow and memory-hungry).

Failure contract (bench.py's): the line always parses and the exit code is
0. Each cell is fenced: a failure writes ``{key}_error`` and the other cells
still run; a failed headline gives ``value: null`` and ``error``. Without a
CUDA device nothing is timed, on the CPU or elsewhere: the line has
``value: null``, ``error: "no_cuda_device"`` and, as context only, the last
successful line (``last_measured``, cached in ``build/bench_last.json``
beside this module) and ``mt_scaling``, the native CPU codec's compress
throughput over thread counts on the host.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import codec_torch, compress_device, decompress_device, golden, native, utils

METRIC = "fp32 1D 2^24 decompression throughput (single GPU, device time)"
REPS, WARMUP = 10, 2
#: the environment variable that adds FULL_CELLS
FULL_ENV = "NDZIP_TORCH_BENCH_FULL"
LAST_PATH = Path(__file__).resolve().parent / "build" / "bench_last.json"
TIMING = (f"CUDA events around each call, its launches queued behind a spin kernel "
          f"(utils.device_time_ms(queued=True)): median of {REPS} after {WARMUP} warm-ups")
MULTIHOST = ("not timed here: the multi-process path (parallel.multihost over torch.distributed) is held by "
             "tests/test_torch_multihost.py, on the card by its cuda cases")


def fp32_1d(rng) -> np.ndarray:
    """bench.py:150-153: sin(i * 1e-4) + 1e-3 * N(0, 1), 2^24 fp32."""
    n = 2**24
    return (np.sin(np.arange(n, dtype=np.float32) * 1e-4)
            + 0.001 * rng.standard_normal(n).astype(np.float32))


def fp64(rng) -> np.ndarray:
    """bench.py:284-289: the same formula in float64, 2^23."""
    n = 2**23
    return np.sin(np.arange(n, dtype=np.float64) * 1e-4) + 0.001 * rng.standard_normal(n)


def cesm(rng) -> np.ndarray:
    """bench.py:291-297: sin(y) cos(x) + 1e-3 * N(0, 1) on 1800x3600, fp32."""
    shape = (1800, 3600)
    y = np.linspace(0, 11.0, shape[0], dtype=np.float64)[:, None]
    x = np.linspace(0, 7.0, shape[1], dtype=np.float64)[None, :]
    return (np.sin(y) * np.cos(x) + 0.001 * rng.standard_normal(shape)).astype(np.float32)


def cube3d(rng) -> np.ndarray:
    """bench.py:300-306: sin(z) cos(y) sin(2x) + 1e-3 * N(0, 1) on 256^3, fp32."""
    shape = (256, 256, 256)
    z = np.linspace(0, 5.0, 256, dtype=np.float64)
    return (np.sin(z[:, None, None]) * np.cos(z[None, :, None]) * np.sin(z[None, None, :] * 2)
            + 0.001 * rng.standard_normal(shape)).astype(np.float32)


def fp64_512cube(rng) -> np.ndarray:
    """bench.py:310-317: sin(z) cos(y) sin(2x) + 1e-3 * N(0, 1) on 512^3, fp64 (1 GiB)."""
    shape = (512, 512, 512)
    z = np.linspace(0, 9.0, 512)
    return (np.sin(z[:, None, None]) * np.cos(z[None, :, None]) * np.sin(z[None, None, :] * 2)
            + 0.001 * rng.standard_normal(shape))


def fp32_2gib_3d(rng) -> np.ndarray:
    """bench.py:319-328: sin(z) cos(y) sin(x) + 1e-3 * N(0, 1) on 512x512x2048, fp32 (2 GiB)."""
    shape = (512, 512, 2048)
    z = np.linspace(0, 9.0, 512, dtype=np.float32)
    x = np.linspace(0, 4.0, 2048, dtype=np.float32)
    d = (np.sin(z[:, None, None]) * np.cos(z[None, :, None]) * np.sin(x[None, None, :])).astype(np.float32)
    d += 0.001 * rng.standard_normal(shape).astype(np.float32)
    return d


#: bench.py's cells in the order they draw from its one generator: (key, data function, what the
#: stream is held to)
CELLS = (("fp32_1d", fp32_1d, "golden"), ("fp64", fp64, "golden"), ("cesm", cesm, "golden"),
         ("cube3d", cube3d, "golden"))
FULL_CELLS = (("fp64_512cube", fp64_512cube, "plain"), ("fp32_2gib_3d", fp32_2gib_3d, "plain"))
HEADLINE = "fp32_1d"


def measure_cell(data: np.ndarray, gate: str, dev) -> dict:
    """One cell on the card ``dev``: the gates, then the median device times
    in ms of compress, decompress and ``copy_`` (``ms``), the same as GB/s of
    uncompressed bytes (``gbps``), and the ratio. Raises where a gate fails."""
    x = torch.from_numpy(data).to(dev)
    shape, nbytes, bits = tuple(x.shape), data.nbytes, data.dtype.itemsize * 8
    stream, length = compress_device(x)
    words = int(length)
    s = stream[:words]
    if not torch.equal(codec_torch.as_words(decompress_device(s, shape, x.dtype)), codec_torch.as_words(x)):
        raise RuntimeError("the round trip on the card is not bit-exact")
    if gate == "golden":
        same = s.cpu().numpy().tobytes() == golden.compress(data)[0].tobytes()
    else:
        plain, plain_words = codec_torch.encode(codec_torch.as_words(x))
        same = int(plain_words) == words and torch.equal(plain[:words], s)
        del plain
    if not same:
        raise RuntimeError(f"the stream on the card differs from the {gate} stream")
    dst = torch.empty_like(x)
    ms = {"compress": utils.device_time_ms(lambda: compress_device(x), REPS, WARMUP, queued=True),
          "decompress": utils.device_time_ms(lambda: decompress_device(s, shape, x.dtype), REPS, WARMUP,
                                             queued=True),
          "copy": utils.device_time_ms(lambda: dst.copy_(x), REPS, WARMUP, queued=True)}
    return {"ms": ms, "gbps": {k: nbytes / (v * 1e-3) / 1e9 for k, v in ms.items()},
            "ratio": golden.compressed_length_words(words, bits) * (bits // 8) / nbytes}


def run_cells(cells, measure, seed: int = 0) -> tuple[dict, dict]:
    """Each cell's data from one ``np.random.default_rng(seed)``, drawn in
    order, through ``measure(data, gate)``, fenced. Returns the rows of the
    cells that passed, by key, and the line's keys of every cell."""
    rng = np.random.default_rng(seed)
    rows, extra = {}, {}
    for key, make, gate in cells:
        try:
            row = measure(make(rng), gate)
        except Exception as e:  # a cell's failure is its line's key; the other cells still run
            traceback.print_exc(file=sys.stderr)
            extra[f"{key}_error"] = f"{type(e).__name__}: {e}"[:300]
            continue
        rows[key] = row
        for what in ("compress", "decompress", "copy"):
            extra[f"{key}_{what}_gbps"] = round(row["gbps"][what], 3)
        extra[f"{key}_ratio"] = round(row["ratio"], 4)
    return rows, extra


def result_line(rows: dict, extra: dict, device: str, mt_scaling) -> dict:
    """The line of a run on the card from ``run_cells``'s rows and keys."""
    head = rows.get(HEADLINE)
    line = {"metric": METRIC, "value": None, "unit": "GB/s", "vs_baseline": None}
    summary = {}
    if head is None:
        line["error"] = extra[f"{HEADLINE}_error"]
    else:
        gbps = head["gbps"]
        line.update(value=round(gbps["decompress"], 3), vs_baseline=round(gbps["decompress"] / gbps["copy"], 3))
        summary = {"compress_gbps": round(gbps["compress"], 3), "ratio": round(head["ratio"], 4)}
    line["extra"] = {**summary, "backend": "cuda", "timing": TIMING, "device": device, "multihost": MULTIHOST,
                     "mt_scaling": mt_scaling, **extra}
    return line


def run(full: bool = False, dev="cuda") -> dict:
    """The bench's line from a run on the card ``dev``."""
    rows, extra = run_cells(CELLS + (FULL_CELLS if full else ()), lambda data, gate: measure_cell(data, gate, dev))
    return result_line(rows, extra, utils.card(), mt_scaling_probe())


def mt_scaling_probe():
    """The native CPU codec's compress throughput in GB/s over thread counts,
    best of 3 on the host's clock (bench.py:97-124), or why there is none."""
    ncpu = os.cpu_count() or 1
    if ncpu <= 1:
        return "1-vcpu"
    try:
        if not native.available():
            return f"{ncpu}-vcpu (native codec unavailable)"
        rng = np.random.default_rng(7)
        data = (np.sin(np.arange(2**22, dtype=np.float32) * 1e-4)
                + 0.001 * rng.standard_normal(2**22).astype(np.float32))
        table = {}
        for t in sorted({1, 2, 4, ncpu} & set(range(1, ncpu + 1))):
            native.compress(data, threads=t)  # warm
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                native.compress(data, threads=t)
                best = min(best, time.perf_counter() - t0)
            table[str(t)] = round(data.nbytes / best / 1e9, 3)
        return {"threads_to_compress_gbps": table, "ncpu": ncpu}
    except Exception as e:  # context only: it must not break the line
        return f"{ncpu}-vcpu (probe failed: {type(e).__name__})"


def load_last():
    try:
        return json.loads(LAST_PATH.read_text())
    except (OSError, ValueError):
        return None


def save_last(line: dict):
    try:
        LAST_PATH.parent.mkdir(parents=True, exist_ok=True)
        LAST_PATH.write_text(json.dumps(line, indent=1) + "\n")
    except OSError:
        pass  # the cache must never break the bench


def unavailable(error: str) -> dict:
    """The line when nothing was timed: the error, the last line measured on
    a card where there is one, and the host's native codec."""
    context = {} if (last := load_last()) is None else {"last_measured": last}
    return {"metric": METRIC, "value": None, "unit": "GB/s", "vs_baseline": None, "error": error,
            "extra": {**context, "mt_scaling": mt_scaling_probe()}}


def emit(obj: dict):
    """The one line, last on stdout, always valid JSON."""
    print(json.dumps(obj), flush=True)


def main() -> int:
    try:
        if not torch.cuda.is_available():
            emit(unavailable("no_cuda_device"))
            return 0
        line = run(full=bool(os.environ.get(FULL_ENV)))
        if line["value"] is not None:
            save_last(line)
        emit(line)
    except Exception as e:  # the line must parse whatever failed
        traceback.print_exc(file=sys.stderr)
        emit(unavailable(f"{type(e).__name__}: {e}"[:300]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
