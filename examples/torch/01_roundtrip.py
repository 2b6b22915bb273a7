"""Host-side usage of the PyTorch/CUDA port: compress and decompress numpy
arrays, pick backends, and drive the CLI: the workflow of the reference's
`compress` tool (src/compress/compress.cc).

Runs on the GPU by default (`python examples/torch/01_roundtrip.py`); pass
`--cpu` for the plain PyTorch path on the CPU. Without a GPU and without
`--cpu` it stops with an error: nothing falls back. Every backend emits the
same stream bytes.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
import ndzip_tpu_torch as nt  # noqa: E402
from ndzip_tpu_torch import api  # noqa: E402

use_cpu = "--cpu" in sys.argv
if not use_cpu and not torch.cuda.is_available():
    sys.exit("no NVIDIA GPU answers (torch.cuda.is_available() is false); pass --cpu for the plain path")
device, engine = ("cpu", "torch") if use_cpu else ("cuda", "cuda")

# A CESM-like 2D field: smooth in both axes, fp32.
y, x = np.mgrid[0:180, 0:360].astype(np.float32)
data = (np.sin(y * 0.05) * np.cos(x * 0.03)).astype(np.float32)

# --- one-call API on the chosen device --------------------------------------
stream, words = nt.compress(data, device=device)
out = nt.decompress(stream, data.shape, np.float32, device=device)
assert np.array_equal(out, data)
print(f"{device}: shape {data.shape}  ratio {4 * words / data.nbytes:.3f}  ({words} stream words)")

# --- every backend, same bytes ------------------------------------------------
backends = ["golden", "cpu", "torch"] + ([] if use_cpu else ["cuda"])
streams = {}
for backend in backends:
    off = api.make_offloader(backend, np.float32, 2)
    s, n = off.compress(data)
    streams[backend] = s[:n].tobytes()
assert len(set(streams.values())) == 1
print(" == ".join(backends), "stream bytes:", len(streams["golden"]), "bytes")

# --- reusable compressor objects ---------------------------------------------
comp = api.make_compressor(np.float32, dims=2, backend=engine)
dec = api.make_decompressor(np.float32, dims=2, backend=engine)
s, n = comp.compress(data)
assert np.array_equal(dec.decompress(s, data.shape), data)
print(f"{engine} backend compressor/decompressor round trip OK")

# --- the CLI, flag for flag the reference's `compress` -----------------------
with tempfile.TemporaryDirectory() as td:
    raw, packed, back = Path(td) / "field.f32", Path(td) / "field.ndz", Path(td) / "back.f32"
    data.tofile(raw)
    cli = [sys.executable, "-m", "ndzip_tpu_torch.cli", "-e", engine, "-t", "float", "-n", "180", "360"]
    subprocess.run(cli + ["-i", str(raw), "-o", str(packed)], check=True, cwd=REPO)
    subprocess.run(cli + ["-d", "-i", str(packed), "-o", str(back)], check=True, cwd=REPO)
    assert packed.read_bytes() == streams["golden"]
    assert np.array_equal(np.fromfile(back, np.float32).reshape(data.shape), data)
    print(f"CLI round trip OK with -e {engine} ({packed.stat().st_size} compressed bytes)")

print("OK")
