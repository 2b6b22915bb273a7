"""The port's test data: the recipe of tests/test_pallas.py (``normal``) and
the small grids that the kernels are held to on the card. Imports numpy
alone, so that it loads where the JAX package cannot."""

import numpy as np


def normal(shape, seed, dtype=np.float32) -> np.ndarray:
    """tests/test_pallas.py's data: normal values, a run of zeros and a
    repeated run. ``seed`` is a seed or a ``numpy.random.Generator``, which
    is drawn from as it stands."""
    d = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    flat = d.reshape(-1)
    flat[:200] = 0
    flat[300:340] = flat[299]
    return d


def special_floats(d: np.ndarray) -> np.ndarray:
    """``d`` with NaNs, infinities, negative zeros and denormals written into
    it (fp64: two NaNs with payloads too)."""
    flat = d.reshape(-1)
    flat[[5, 4100, 9000]] = np.nan
    if d.dtype == np.float64:
        flat[[9, 4103]] = np.array([0x7FF0000000000001, 0xFFF80000DEADBEEF], np.uint64).view(np.float64)
    flat[[6, 4101]] = np.inf
    flat[[7, 20000]] = -np.inf
    flat[[8, 4102, 32790]] = -0.0
    tiny = np.float32(1e-42) if d.dtype == np.float32 else 5e-324
    flat[1000:1064] = tiny * np.arange(64, dtype=d.dtype)  # denormals
    return d


def kernel_cases() -> dict[str, np.ndarray]:
    """Small fp32 1D inputs for the 1D kernels: whole blocks and a border,
    zeros, random bits (every block at its 4224-word maximum), a constant,
    one block, special floats, and HACC's structure (an even block count and
    a border of 1,035 elements, as 280,953,867 = 4096 x 68,592 + 1,035)."""
    rng = np.random.default_rng(0)
    special = special_floats(normal(4096 * 8 + 37, rng))
    return {
        "4096*8": normal(4096 * 8, rng),
        "4096*8+100": normal(4096 * 8 + 100, rng),
        "all zeros": np.zeros(4096 * 8, np.float32),
        "random bits": rng.integers(0, 2**32, 4096 * 8, dtype=np.uint64).astype(np.uint32),
        "constant": np.full(4096 * 8, 3.25, np.float32),
        "single block": normal(4096, rng),
        "nan/inf/-0/denormal": special,
        "4096*6+1035": normal(4096 * 6 + 1035, rng),
    }


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
    rng = np.random.default_rng(0)
    special = special_floats(normal((32, 32, 48), rng))
    return {
        "2d (128,192)": normal((128, 192), rng),
        "2d (128,512)": normal((128, 512), rng),
        "2d border (130,513)": normal((130, 513), rng),
        "3d border (32,32,33)": normal((32, 32, 33), rng),
        "3d (16,32,128)": normal((16, 32, 128), rng),
        "3d border (17,32,129)": normal((17, 32, 129), rng),
        "3d constant (32,32,32)": np.full((32, 32, 32), 3.25, np.float32),
        "2d random bits (128,256)": rng.integers(0, 2**32, (128, 256), dtype=np.uint64).astype(np.uint32),
        "3d nan/inf/-0/denormal (32,32,48)": special,
        "2d all border (63,100)": normal((63, 100), rng),
    }


def fp64_kernel_cases() -> dict[str, np.ndarray]:
    """Small fp64 grids for the four fp64 kernels: tests/test_pallas.py's
    SHAPES64 (1D with an odd block count, the header's pad word and a border;
    2D/3D with borders, minor extents even (16-byte rows) and odd (one word a
    lane)), zeros, random 64-bit words (every block at its 4160-word
    maximum), a constant, special floats, and one all-border grid."""
    rng = np.random.default_rng(0)

    def normal64(shape):
        return normal(shape, rng, np.float64)

    return {
        "1d 4096*8": normal64(4096 * 8),
        "1d odd block count + border 4096*3+1": normal64(4096 * 3 + 1),
        "1d all zeros": np.zeros(4096 * 8),
        "1d random bits": rng.integers(0, 2**64, 4096 * 8, dtype=np.uint64).view(np.float64),
        "1d constant": np.full(4096 * 8, 3.25),
        "1d nan/inf/-0/denormal": special_floats(normal64(4096 * 8 + 37)),
        "2d border (128,70)": normal64((128, 70)),
        "3d (16,32,32)": normal64((16, 32, 32)),
        "2d (128,512)": normal64((128, 512)),
        "3d border (17,16,128)": normal64((17, 16, 128)),
        "3d odd minor extent (17,32,129)": normal64((17, 32, 129)),
        "2d random bits (128,192)": rng.integers(0, 2**64, (128, 192), dtype=np.uint64).view(np.float64),
        "3d nan/inf/-0/denormal (32,32,48)": special_floats(normal64((32, 32, 48))),
        "3d all border (15,16,200)": normal64((15, 16, 200)),
    }
