"""Build the CUDA kernels from ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface, so nvcc builds them in seconds: one
nvcc for each ``.cu``, all started together, then one link into a shared
library under ``build/``, named by a hash of the sources and the flags: a
changed source builds anew, an unchanged one loads what is there. What ptxas
says of each kernel (registers, shared memory, spills) is kept beside the
library (``ptxas_report``). There is no fallback. If nvcc is missing or
fails, ``load`` raises with its output, and nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
#: C entry points and their arguments (see the .cu files).
SIGNATURES = {
    # words, num_hc, border, stream, status (num_hc + 1 64-bit words), length, cuda stream
    "ndzip_encode_fp32": [_P, _I64, _I64, _P, _P, _P, _P],
    # stream, size, num_hc, border, out, cuda stream
    "ndzip_decode_fp32": [_P, _I64, _I64, _I64, _P, _P],
    # the CTAs of the 1D fp32 kernels that one SM holds, or minus a CUDA error
    "ndzip_encode_fp32_ctas_per_sm": [],
    "ndzip_decode_fp32_ctas_per_sm": [],
    # words, dims, e0, e1, e2 (the shape padded in front with 1s), stream, status (num_hc + 1
    # 64-bit words), length, cuda stream
    "ndzip_encode_fp32_nd": [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _P],
    # stream, size, dims, e0, e1, e2, out, cuda stream
    "ndzip_decode_fp32_nd": [_P, _I64, _I64, _I64, _I64, _I64, _P, _P],
    # dims: the CTAs of the 2D or 3D fp32 kernels that one SM holds, or minus a CUDA error
    "ndzip_encode_fp32_nd_ctas_per_sm": [_I64],
    "ndzip_decode_fp32_nd_ctas_per_sm": [_I64],
    # the CTAs of the 3D fp32 encoder's and decoder's box paths (rows 16-byte aligned) that one
    # SM holds
    "ndzip_encode_fp32_nd_box_ctas_per_sm": [],
    "ndzip_decode_fp32_nd_box_ctas_per_sm": [],
    # the fp64 kernels take the arguments of the fp32 ones; words, out and sizes count u64
    # words, except the stream's size and length, which count u32 words
    "ndzip_encode_fp64": [_P, _I64, _I64, _P, _P, _P, _P],
    "ndzip_decode_fp64": [_P, _I64, _I64, _I64, _P, _P],
    "ndzip_encode_fp64_ctas_per_sm": [],
    "ndzip_decode_fp64_ctas_per_sm": [],
    "ndzip_encode_fp64_nd": [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _P],
    "ndzip_decode_fp64_nd": [_P, _I64, _I64, _I64, _I64, _I64, _P, _P],
    "ndzip_encode_fp64_nd_ctas_per_sm": [_I64],
    "ndzip_decode_fp64_nd_ctas_per_sm": [_I64],
    # stage kernels (stages.py). words, num_hc, out, cuda stream
    "ndzip_placement_floor": [_P, _I64, _P, _P],
    "ndzip_placement_compute": [_P, _I64, _P, _P],
    # x, rows, limit, out, cuda stream
    "ndzip_keep_mask": [_P, _I64, _I64, _P, _P],
    # grid (gather) or blocks (scatter), word bytes, dims, e0, e1, e2, the other one, cuda stream
    "ndzip_gather_blocks_nd": [_P, _I64, _I64, _I64, _I64, _I64, _P, _P],
    "ndzip_scatter_blocks_nd": [_P, _I64, _I64, _I64, _I64, _I64, _P, _P],
}


def _find_nvcc() -> str | None:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc")


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libndzip_cuda_{h.hexdigest()[:16]}.so"


def ptxas_report(csrc: Path = CSRC) -> str:
    """What ``ptxas -v`` printed when the library was built, one nvcc after
    the other: per kernel its registers, shared memory and spills."""
    return build(csrc).with_suffix(".ptxas.txt").read_text()


def ptxas_lines(kernel: str, csrc: Path = CSRC) -> list[str]:
    """ptxas's lines (registers and shared memory; stack and spills) for each
    kernel whose mangled name contains ``kernel``, as ``name: lines``."""
    report = ptxas_report(csrc).splitlines()
    found = []
    for i, line in enumerate(report):
        if "Compiling entry" in line and kernel in line:
            name = line.split("'")[1] if "'" in line else line
            found.append(f"{name}: " + " ".join(r.replace("ptxas info    :", "").strip()
                                                for r in report[i + 2: i + 4]))
    return found


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources of ``csrc`` (the package's own, or a directory of
    variants of them) unless a library built from them exists."""
    lib = library_path(csrc)
    if lib.exists():
        return lib
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
                           "and PATH): the CUDA kernels of ndzip_tpu_torch cannot be built")
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for src in sorted(csrc.glob("*.cu")):  # one nvcc per source, all started together
            objs.append(os.path.join(tmp, f"{src.stem}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
        failed, report = [], []
        for cmd, proc in procs:
            _, err = proc.communicate()
            report.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        so = os.path.join(tmp, lib.name)
        if not failed:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(so, lib)  # atomic: another process never loads half a library
    return lib


def load_from(csrc: Path, names=None) -> ctypes.CDLL:
    """The library built from the sources of ``csrc``, with the signatures of
    ``names`` (default: all) set on it."""
    lib = ctypes.CDLL(str(build(csrc)))
    for name in SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once per process."""
    return load_from(CSRC)
