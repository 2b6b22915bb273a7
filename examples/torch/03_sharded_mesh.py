"""Block-parallel compression over several devices: the scale-out layer
that the reference, a single-device codec, does not have. The grid is cut
into full-width row slabs along axis 0, each device compresses its slab
with the same kernels as the single-device path, and the assembled stream
is byte for byte the serial one.

A mesh is a list of devices, and one device may appear several times.
By default the mesh is every visible GPU (`parallel.make_mesh()`), and on a
machine with one card four shards share it; `--cpu` runs eight shards on
the CPU through the plain PyTorch path. Without a GPU and without `--cpu`
it stops with an error: nothing falls back.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from ndzip_tpu_torch import golden, parallel  # noqa: E402

use_cpu = "--cpu" in sys.argv
if not use_cpu and not torch.cuda.is_available():
    sys.exit("no NVIDIA GPU answers (torch.cuda.is_available() is false); pass --cpu for the plain path")
if use_cpu:
    mesh = ["cpu"] * 8
else:
    mesh = list(parallel.make_mesh())        # every visible GPU
    if len(mesh) == 1:
        mesh *= 4                            # one card: four shards on it
print("mesh:", [str(d) for d in mesh])

# A 3D fp32 field whose block rows split over the shards.
z, y, x = np.mgrid[0:128, 0:32, 0:64].astype(np.float32)
data = (np.sin(z * 0.1) + np.cos(y * 0.2) * np.sin(x * 0.05)).astype(np.float32)

stream, words = parallel.compress_sharded(data, mesh)
serial, serial_words = golden.compress(data)
assert words == serial_words and stream.tobytes() == serial.tobytes()
print(f"sharded stream == serial stream ({words} words, ratio {4 * words / data.nbytes:.3f})")

out = parallel.decompress_sharded(stream, data.shape, np.float32, mesh)
assert np.array_equal(out, data)
print("sharded decode OK: every shard decoded its own blocks")

# fp64 works the same way, on native 64-bit words; lengths count u64 words.
d64 = np.cumsum(np.random.default_rng(0).standard_normal(128 * 32 * 16)).reshape(128, 32, 16)
s64, w64 = parallel.compress_sharded(d64, mesh)
g64, gw64 = golden.compress(d64)
assert w64 == gw64 and s64.tobytes() == g64.tobytes()
assert np.array_equal(parallel.decompress_sharded(s64, d64.shape, np.float64, mesh), d64)
print("fp64 sharded stream == serial stream, round trip bit-exact")

print("OK")
