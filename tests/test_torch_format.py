"""The port's own copies of the numpy-only modules (``format``, ``golden``,
``io``, ``native``) against the JAX package's, exact equality on the same
inputs from a numpy seed; and the rule that the port, its walkthroughs
(``examples/torch/``) and the tests' data module ``tests/torch_cases.py``
import nothing of ``ndzip_tpu`` and no JAX, held by a walk of their syntax
trees."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ndzip_tpu.format as ref_format
import ndzip_tpu.golden as ref_golden
import ndzip_tpu.io as ref_io
import ndzip_tpu.native as ref_native
from ndzip_tpu_torch import format as fmt
from ndzip_tpu_torch import golden, native
from ndzip_tpu_torch import io as ndz_io
from torch_cases import normal

ROOT = Path(__file__).resolve().parents[1]

# the shapes of the port's other tests: 1-3D, with and without borders, all border, one block
SHAPES = [
    (4096,), (4096 * 2,), (4096 * 2 + 5,), (4096 * 3 + 1,), (4096 * 8 + 100,), (100,), (0,),
    (64, 64), (128, 192), (130, 192), (128, 193), (130, 513), (128, 70), (63, 100), (64, 10), (1800, 130),
    (16, 16, 16), (32, 32, 32), (33, 32, 32), (32, 33, 32), (32, 32, 33), (33, 33, 32), (33, 32, 33),
    (32, 33, 33), (17, 32, 129), (17, 16, 128), (15, 16, 200), (16, 16, 15), (40, 3, 50),
]

SHAPE_FUNCTIONS = ["num_hypercubes", "grid_shape", "border_element_count", "border_slices"]
SHAPE_ITER_FUNCTIONS = ["hypercube_origins"]
SHAPE_BITS_FUNCTIONS = ["compressed_bound_u32", "compressed_bound_words"]
COUNT_FUNCTIONS = ["header_u32_entries"]
COUNT_BITS_FUNCTIONS = ["header_words", "header_u32_words"]
NUM_HCS = (0, 1, 2, 3, 8, 4095, 4096, 65536, 65537)


@pytest.mark.parametrize("name", SHAPE_FUNCTIONS)
def test_shape_functions_equal_the_reference(name):
    for shape in SHAPES:
        assert getattr(fmt, name)(shape) == getattr(ref_format, name)(shape), shape


@pytest.mark.parametrize("name", SHAPE_ITER_FUNCTIONS)
def test_shape_iterators_equal_the_reference(name):
    for shape in SHAPES:
        assert list(getattr(fmt, name)(shape)) == list(getattr(ref_format, name)(shape)), shape


@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("name", SHAPE_BITS_FUNCTIONS)
def test_bounds_equal_the_reference(name, word_bits):
    for shape in SHAPES:
        assert getattr(fmt, name)(shape, word_bits) == getattr(ref_format, name)(shape, word_bits), shape


@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("name", COUNT_BITS_FUNCTIONS)
def test_header_sizes_equal_the_reference(name, word_bits):
    for num_hc in NUM_HCS:
        assert getattr(fmt, name)(num_hc, word_bits) == getattr(ref_format, name)(num_hc, word_bits)


@pytest.mark.parametrize("name", COUNT_FUNCTIONS)
def test_counts_equal_the_reference(name):
    for num_hc in NUM_HCS:
        assert getattr(fmt, name)(num_hc) == getattr(ref_format, name)(num_hc)


@pytest.mark.parametrize("word_bits", [32, 64])
def test_golden_length_words_equals_the_reference(word_bits):
    for shape in SHAPES:
        for u32 in (fmt.compressed_bound_u32(shape, word_bits), fmt.header_u32_words(fmt.num_hypercubes(shape), 64)):
            assert golden.compressed_length_words(u32, word_bits) == ref_golden.compressed_length_words(u32, word_bits)


@pytest.mark.parametrize("name", ["SIDE_LENGTH", "HC_SIZE", "FORWARD_AXIS_ORDER", "MAX_DIMENSIONALITY"])
def test_constants_equal_the_reference(name):
    assert getattr(fmt, name) == getattr(ref_format, name)


@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.int32, np.float64, np.uint64, np.int64,
                                   np.float16, np.int8], ids=lambda d: np.dtype(d).name)
def test_word_bits_for_dtype_equals_the_reference(dtype):
    try:
        want = ref_format.word_bits_for_dtype(dtype)
    except ValueError:
        with pytest.raises(ValueError):
            fmt.word_bits_for_dtype(dtype)
    else:
        assert fmt.word_bits_for_dtype(dtype) == want


@pytest.mark.parametrize("shape", [(), (1, 2, 3, 4), (4, -1), (-5,), (4096,), (3, 0, 2)], ids=str)
def test_validate_shape_equals_the_reference(shape):
    try:
        ref_format.validate_shape(shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fmt.validate_shape(shape)
        assert str(got.value) == str(e)
    else:
        fmt.validate_shape(shape)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float", "double"])
def test_profiles_equal_the_reference(dtype, dims):
    mine, ref = fmt.profile_for(dtype, dims), ref_format.profile_for(dtype, dims)
    for name in ("word_bits", "dims", "side_length", "hc_size", "word_bytes", "heads_per_block",
                 "compressed_block_length_bound", "block_shape"):
        assert getattr(mine, name) == getattr(ref, name), name
    with pytest.raises(ValueError):
        fmt.Profile(16, dims)


def golden_data(dtype, shape, seed):
    """Normal values with a run of zeros, a constant run and a few special floats."""
    data = normal(shape, seed, dtype)
    flat = data.reshape(-1)
    flat[[5, 4100]] = np.nan
    flat[[6, 4101]] = [np.inf, -np.inf]
    flat[7] = -0.0
    return data


GOLDEN_PROFILES = [(np.float32, (4096 * 3 + 37,)), (np.float32, (130, 193)), (np.float32, (17, 32, 33)),
                   (np.float64, (4096 * 3 + 1,)), (np.float64, (128, 70)), (np.float64, (17, 16, 35))]


@pytest.mark.parametrize("dtype,shape", GOLDEN_PROFILES,
                         ids=[f"{np.dtype(d).name}-{len(s)}d" for d, s in GOLDEN_PROFILES])
def test_golden_streams_equal_the_reference(dtype, shape):
    data = golden_data(dtype, shape, len(shape))
    stream, words = golden.compress(data)
    ref_stream, ref_words = ref_golden.compress(data)
    assert words == ref_words and stream.dtype == ref_stream.dtype
    assert stream.tobytes() == ref_stream.tobytes()
    out, ref_out = golden.decompress(stream, shape, dtype), ref_golden.decompress(ref_stream, shape, dtype)
    assert out.dtype == ref_out.dtype and out.shape == ref_out.shape
    assert out.tobytes() == ref_out.tobytes() == data.tobytes()


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("word", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_golden_stages_equal_the_reference(word, dims):
    bits = np.dtype(word).itemsize * 8
    blocks = np.random.default_rng(dims).integers(0, 2**bits, (3, 4096), dtype=np.uint64).astype(word)
    blocks[1, 100:3000] = 0
    for mine, ref in zip(golden.encode_blocks_dense(blocks, dims), ref_golden.encode_blocks_dense(blocks, dims)):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    t = golden.block_transform(blocks, dims)
    assert np.array_equal(t, ref_golden.block_transform(blocks, dims))
    assert np.array_equal(golden.inverse_block_transform(t, dims), blocks)
    dense = ref_golden.encode_blocks_dense(blocks, dims)[0]
    assert np.array_equal(golden.decode_blocks_dense(dense, dims), blocks)


@pytest.mark.parametrize("use_mmap", [True, False], ids=["mmap", "stdio"])
def test_io_round_trip_through_a_file_equals_the_reference(tmp_path, use_mmap):
    shape, dtype = (70, 66), np.float32
    chunks = [golden_data(dtype, shape, seed) for seed in range(3)]
    files = {}
    for label, mod in (("port", ndz_io), ("reference", ref_io)):
        raw, ndz, back = (tmp_path / f"{label}.{ext}" for ext in ("raw", "ndz", "back"))
        raw.write_bytes(b"".join(c.tobytes() for c in chunks))
        inp, outp = mod.open_input(str(raw), use_mmap), mod.open_output(str(ndz), use_mmap)
        for view in inp.read_exact(chunks[0].nbytes):
            outp.write_chunk(golden.compress(np.frombuffer(view, dtype=dtype).reshape(shape))[0])
        inp.close()
        outp.close()
        inp, outp = mod.open_input(str(ndz), use_mmap), mod.open_output(str(back), use_mmap)
        bound, consumed, lengths = fmt.compressed_bound_words(shape, 32) * 4, 0, []
        while (window := inp.read_some(bound, consumed)) is not None:
            consumed = mod.compressed_chunk_bytes(window, shape, dtype)
            lengths.append(consumed)
            outp.write_chunk(golden.decompress(np.frombuffer(window[:consumed], dtype=np.uint32), shape, dtype))
        inp.close()
        outp.close()
        assert back.read_bytes() == raw.read_bytes()
        files[label] = (ndz.read_bytes(), lengths)
    assert files["port"] == files["reference"] and len(files["port"][1]) == 3


def test_io_trailing_partial_chunk_raises(tmp_path):
    path = tmp_path / "short.raw"
    path.write_bytes(bytes(100))
    for use_mmap in (True, False):
        inp = ndz_io.open_input(str(path), use_mmap)
        with pytest.raises(IOError):
            list(inp.read_exact(64))
        inp.close()


@pytest.fixture
def both_native():
    if not (native.available() and ref_native.available()):
        pytest.skip("the native C++ codec does not build here: no C++ compiler")


@pytest.mark.parametrize("dtype,shape", GOLDEN_PROFILES,
                         ids=[f"{np.dtype(d).name}-{len(s)}d" for d, s in GOLDEN_PROFILES])
def test_native_equals_the_reference(both_native, dtype, shape):
    data = golden_data(dtype, shape, 10 + len(shape))
    stream, words = native.compress(data, threads=2)
    ref_stream, ref_words = ref_native.compress(data, threads=2)
    assert words == ref_words and stream.tobytes() == ref_stream.tobytes()
    assert stream.tobytes() == golden.compress(data)[0].tobytes()
    assert native.decompress(stream, shape, dtype).tobytes() == data.tobytes()


def test_native_builds_apart_from_the_reference_library(both_native):
    assert native._LIB.parent == ROOT / "native" / "build" and native._LIB.exists()
    assert native._LIB != ref_native._LIB


def port_sources():
    return (sorted((ROOT / "ndzip_tpu_torch").rglob("*.py")) + sorted((ROOT / "examples" / "torch").glob("*.py"))
            + [ROOT / "tests" / "torch_cases.py"])


def forbidden_imports(tree):
    """Imports of ``ndzip_tpu`` or ``jax`` (the packages or anything under
    them) in a module's syntax tree, wherever they stand."""
    def bad(name):
        return name is not None and name.split(".")[0] in ("ndzip_tpu", "jax", "jaxlib")
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if bad(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and bad(node.module):
            found.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in
              ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str) and bad(node.args[0].value)):
            found.append(node.args[0].value)
    return found


@pytest.mark.parametrize("path", [p.relative_to(ROOT).as_posix() for p in port_sources()])
def test_port_imports_nothing_of_the_jax_package(path):
    assert forbidden_imports(ast.parse((ROOT / path).read_text())) == []


def test_the_import_walk_finds_what_it_looks_for():
    code = ("import ndzip_tpu.format\nfrom ndzip_tpu import golden\nimport jax.numpy as jnp\n"
            "def f():\n    from jax import lax\n    import importlib\n"
            "    return importlib.import_module('ndzip_tpu.io')\n"
            "import ndzip_tpu_torch\nfrom . import format\n")
    assert sorted(forbidden_imports(ast.parse(code))) == ["jax", "jax.numpy", "ndzip_tpu", "ndzip_tpu.format",
                                                          "ndzip_tpu.io"]


def test_entry_points_load_nothing_of_the_jax_package():
    code = ("import ndzip_tpu_torch.api, ndzip_tpu_torch.cli, ndzip_tpu_torch.warm, ndzip_tpu_torch.ubench, sys\n"
            "import ndzip_tpu_torch.parallel, ndzip_tpu_torch.benchmark, ndzip_tpu_torch.competitors\n"
            "import ndzip_tpu_torch.plot_benchmark, ndzip_tpu_torch.bench\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('ndzip_tpu', 'jax'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
