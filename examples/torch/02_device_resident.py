"""Device-resident compression: the data is a tensor the program already
holds on the GPU, and the compressed stream stays there: the workflow of the
reference's `cuda_compressor` over device pointers (include/ndzip/cuda.hh).
Typical use: compress a field right before a transfer or a checkpoint write.

Also shown: the Offloader's kernel timing. With `timing_mode="device"` it
stages the data on the card first, then times only `compress_device` or
`decompress_device` between two CUDA events, the launches queued behind a
spin kernel, so the reading is the device's time alone (the reference's
`kernel_duration`, offload.hh:16-24); `measure()` gives the median of 10.

Runs on the GPU by default; `--cpu` runs the same calls on CPU tensors
through the plain PyTorch path (same bytes, host speed), with host-clock
timing and no `measure()`, which needs the card. Without a GPU and without
`--cpu` it stops with an error: nothing falls back.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu_torch import api, golden  # noqa: E402

use_cpu = "--cpu" in sys.argv
if not use_cpu and not torch.cuda.is_available():
    sys.exit("no NVIDIA GPU answers (torch.cuda.is_available() is false); pass --cpu for the plain path")
device = "cpu" if use_cpu else "cuda"

data = np.sin(np.arange(2**20, dtype=np.float32) * 1e-4)

# --- tensors in, tensors out: nothing leaves the device -----------------------
x = torch.from_numpy(data).to(device)
stream, length = nt.compress_device(x)         # int32 stream, int32 scalar on the device: no host sync
back = nt.decompress_device(stream[:length], x.shape)
assert torch.equal(back.view(torch.int32), x.view(torch.int32))
assert stream[: int(length)].cpu().numpy().tobytes() == golden.compress(data)[0].tobytes()
print(f"stream on {stream.device}: {int(length)} u32 words (ratio {4 * int(length) / data.nbytes:.3f}), "
      "equal to golden's, round trip bit-exact")

z = torch.from_numpy(np.cumsum(np.random.default_rng(0).standard_normal((64, 64, 80)), axis=2)).to(device)
stream, length = nt.compress_device(z)         # fp64: length still counts u32 words
w = nt.decompress_device(stream[:length], z.shape, torch.float64)
assert torch.equal(w.view(torch.int64), z.view(torch.int64))
print(f"fp64 {tuple(z.shape)} round trip bit-exact ({int(length)} u32 words)")

# --- the Offloader: numpy in and out, with the codec's time -------------------
backend, mode = ("torch", "wall") if use_cpu else ("cuda", "device")
off = api.Offloader(np.float32, dims=1, backend=backend, timing_mode=mode)
s, words = off.compress(data)
out = off.decompress(s[:words], data.shape)
assert np.array_equal(out, data)
print(f"Offloader({backend!r}, timing_mode={mode!r}): compress {off.timing.compress_ns / 1e6:.3f} ms, "
      f"decompress {off.timing.decompress_ns / 1e6:.3f} ms"
      + (" of host time" if use_cpu else " of device time (host enqueue left out)"))

if use_cpu:
    print("measure() needs the card: skipped on the CPU")
else:
    t = off.measure(data)
    print(f"measure(): compress {data.nbytes / t.compress_ns:.2f} GB/s, "
          f"decompress {data.nbytes / t.decompress_ns:.2f} GB/s (median of 10, device time) on "
          f"{torch.cuda.get_device_name(0)}")

print("OK")
