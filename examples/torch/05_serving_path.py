"""Device-resident scale-out ("serving path"): the payload never leaves the
devices. A training step that writes or reads compressed checkpoint or
dataset shards wants the codec to take and give tensors that already live
on the devices, not host numpy: `compress_sharded_device` encodes each row
slab where it lies and assembles one stream on the first device;
`decompress_sharded_device` hands each device a sub-stream of its own blocks
and returns one row slab a device.

The JAX package's walkthrough also shows its adaptive decode window
(`codec_pallas.WIN_BUCKETS`, the DMA window of the TPU decoder, sized from
the stream header). It answers a TPU limit and is not ported: the port's
decoders bulk-copy each block's run as long as it is, so there is no window
to pick.

Runs on the GPU by default (every visible card, four shards on one card
where there is one); `--cpu` runs eight shards on the CPU through the plain
PyTorch path. Without a GPU and without `--cpu` it stops with an error:
nothing falls back.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from ndzip_tpu_torch import golden  # noqa: E402
from ndzip_tpu_torch.parallel import (  # noqa: E402
    compress_sharded_device,
    decompress_sharded_device,
    make_mesh,
)

use_cpu = "--cpu" in sys.argv
if not use_cpu and not torch.cuda.is_available():
    sys.exit("no NVIDIA GPU answers (torch.cuda.is_available() is false); pass --cpu for the plain path")
if use_cpu:
    mesh = [torch.device("cpu")] * 8
else:
    mesh = list(make_mesh())
    if len(mesh) == 1:
        mesh *= 4
print("mesh:", [str(d) for d in mesh])

# a "model state" the program already holds on the first device (7 block
# rows over the shards, and a border of 17 words)
shape = (4096 * 7 + 17,)
rng = np.random.default_rng(0)
state = (np.sin(np.arange(shape[0]) * 1e-4) + 0.001 * rng.standard_normal(shape)).astype(np.float32)
state_dev = torch.from_numpy(state).to(mesh[0])

# ---- compress on the devices: stream and length stay there
stream_dev, length_dev = compress_sharded_device(state_dev, mesh)
length = int(length_dev)
expect, elen = golden.compress(state)
assert length == elen and stream_dev[:length].cpu().numpy().tobytes() == expect.tobytes(), \
    "device stream != serial codec bytes"
print(f"compressed on {stream_dev.device}: {length * 4} bytes (ratio {length * 4 / state.nbytes:.3f}), "
      "bit-exact against the serial codec")

# ---- decompress into one row slab a device
slabs = decompress_sharded_device(stream_dev[:length], shape, np.float32, mesh)
print("decoded slabs:", [(str(s.device), tuple(s.shape)) for s in slabs])
out = torch.cat([s.to(mesh[0]) for s in slabs])
assert torch.equal(out.view(torch.int32), state_dev.view(torch.int32))
print("round trip bit-exact; the payload stayed on the devices end to end")

print("OK")
