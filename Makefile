# Convenience targets (the analog of the reference's top-level CMake
# workflow; the Python package itself needs no build step).

.PHONY: all native test test-tpu bench ubench lint clean lint-torch test-cuda bench-torch

all: native

native: native/libndzip_cpu.so native/libndzip_competitors.so

native/libndzip_cpu.so: native/ndzip_cpu.cc
	$(CXX) -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC -pthread $< -o $@

native/libndzip_competitors.so: native/competitors.cc
	$(CXX) -O3 -march=native -funroll-loops -std=c++17 -shared -fPIC -pthread $< -o $@

# CMake variant of the native build
native-cmake:
	cmake -S native -B native/build -G Ninja && cmake --build native/build

test: native
	python -m pytest tests/ -x -q

# Mosaic-compiled kernel regression suite on real TPU hardware (minutes;
# set NDZIP_TPU_CACHE_DIR to make repeat runs take seconds).  One TPU
# process at a time — don't run concurrently with bench.
test-tpu:
	NDZIP_TPU_TESTS_TPU=1 python -m pytest tests/test_tpu_smoke.py -x -q

lint:
	python -m compileall -q ndzip_tpu tests dev examples
	python -m pyflakes ndzip_tpu tests dev examples 2>/dev/null || true

bench: native
	python bench.py

ubench:
	python -m ndzip_tpu.ubench

# The PyTorch/CUDA port (ndzip_tpu_torch).  test-cuda and bench-torch need an
# NVIDIA GPU and nvcc; the kernels build on first use.  test-cuda runs the
# cuda-marked tests of every file that has them and collects without JAX.
lint-torch:
	python -m compileall -q ndzip_tpu_torch
	python -m pyflakes ndzip_tpu_torch

test-cuda:
	NDZIP_TPU_TESTS_TPU=1 python -m pytest tests/test_torch_kernels.py tests/test_torch_stages.py \
		tests/test_torch_api.py tests/test_torch_fuzz.py tests/test_torch_sharded.py \
		tests/test_torch_benchmark.py tests/test_torch_bench.py tests/test_torch_spans.py \
		tests/test_torch_plans.py tests/test_torch_copies.py tests/test_torch_codec_nd.py \
		tests/test_torch_codec64.py tests/test_torch_cli.py tests/test_torch_multihost.py \
		tests/test_torch_examples.py -m cuda -q

bench-torch:
	python -m ndzip_tpu_torch.bench

clean:
	rm -f native/libndzip_cpu.so
	rm -rf native/build
