"""File and pipe workflows: a file of several arrays, stdin/stdout piping,
memory-mapped input and output, and the kernel warmer: the reference's io
library and compress-tool workflows (src/io/io.cc,
src/compress/compress.cc:17-86).

Runs the CLI with `-e cuda` by default; `--cpu` takes `-e torch`, the plain
PyTorch path, and skips `warm`, which needs the card. Without a GPU and
without `--cpu` it stops with an error: nothing falls back.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
from ndzip_tpu_torch import golden  # noqa: E402
from ndzip_tpu_torch import io as ndz_io  # noqa: E402

use_cpu = "--cpu" in sys.argv
if not use_cpu and not torch.cuda.is_available():
    sys.exit("no NVIDIA GPU answers (torch.cuda.is_available() is false); pass --cpu for the plain path")
engine = "torch" if use_cpu else "cuda"

rng = np.random.default_rng(3)
shape = (70, 130)   # not block-aligned: the border paths run
chunk = np.cumsum(rng.standard_normal(np.prod(shape))).astype(np.float32).reshape(shape)
cli = [sys.executable, "-m", "ndzip_tpu_torch.cli", "-e", engine, "-t", "float", "-n", "70", "130"]

with tempfile.TemporaryDirectory() as td:
    td = Path(td)

    # --- a file holding three arrays of the same extent -------------------
    raw = td / "stack.f32"
    with open(raw, "wb") as f:
        for k in range(3):
            (chunk * (k + 1)).tofile(f)
    packed, back = td / "stack.ndz", td / "back.f32"
    subprocess.run(cli + ["-i", str(raw), "-o", str(packed)], check=True, cwd=REPO)
    subprocess.run(cli + ["-d", "-i", str(packed), "-o", str(back)], check=True, cwd=REPO)
    assert back.read_bytes() == raw.read_bytes()
    first = golden.compress(chunk)[0].tobytes()
    assert packed.read_bytes()[: len(first)] == first
    print(f"3-chunk file round trip OK with -e {engine} "
          f"({raw.stat().st_size} -> {packed.stat().st_size} bytes)")

    # --- pipes: compress stdin -> stdout, no seekable files ---------------
    comp = subprocess.run(cli, input=raw.read_bytes(), capture_output=True, check=True, cwd=REPO)
    deco = subprocess.run(cli + ["-d"], input=comp.stdout, capture_output=True, check=True, cwd=REPO)
    assert comp.stdout == packed.read_bytes() and deco.stdout == raw.read_bytes()
    print("stdin -> stdout pipe round trip OK")

    # --- the io layer directly: mmap input, grow-mapped output ------------
    src = ndz_io.open_input(str(raw), use_mmap=True)
    dst = ndz_io.open_output(str(td / "copy.f32"), use_mmap=True)
    for piece in src.read_exact(chunk.nbytes):
        dst.write_chunk(np.frombuffer(piece, np.uint8))
    src.close()
    dst.close()
    assert (td / "copy.f32").read_bytes() == raw.read_bytes()
    print("mmap input -> grow-mapped output copy OK")

# --- build the kernels and load them for the planned shapes ---------------
if use_cpu:
    print("warm needs the card: skipped on the CPU")
else:
    subprocess.run([sys.executable, "-m", "ndzip_tpu_torch.warm", "--shapes", "70x130", "--dtype", "float"],
                   check=True, cwd=REPO)

print("OK")
