# Task runner — the reference's CMake targets mapped to this repo
# (build/test/doc/install, CMakeLists.txt:26-231). The Python package needs
# no compile step; `oracle` builds the native C++ RNG oracle used by the
# bit-exactness tests.

PY ?= python
CPU_ENV = JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

.PHONY: test test-fast test-gpu bench bench-all oracle rng-battery docs install clean

test:
	$(CPU_ENV) $(PY) -m pytest tests/ -q -n 4

test-fast:
	$(CPU_ENV) $(PY) -m pytest tests/ -q -n 4 -x -m "not slow"

# the card-only tests, on a machine with a GPU
test-gpu:
	$(PY) -m pytest tests/ -q -m gpu -o addopts=""

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench_all.py

oracle:
	$(PY) -c "from cl_ops_tpu import native; assert native.available(); print('oracle built')"

# External-consumer statistical battery (NIST SP 800-22 core subset in
# C++) over the dieharder-format emitter files; see RNG_BATTERY.txt.
rng-battery:
	g++ -O2 -std=c++17 cl_ops_tpu/native/rng_battery.cpp \
	    -o cl_ops_tpu/native/rng_battery
	for g in threefry lcg xorshift64 mwc64x parkmiller tauslcg; do \
	    $(PY) -m cl_ops_tpu.bench.rng_bench -g $$g --gws 65536 -r 16 \
	        --output file-dh --out-file /tmp/$$g.dh; done
	$(PY) -m cl_ops_tpu.bench.rng_bench -g tauslcg --gws 65536 -r 16 \
	    --hash xs1 --output file-dh --out-file /tmp/tauslcg_xs1.dh
	./cl_ops_tpu/native/rng_battery /tmp/threefry.dh /tmp/lcg.dh \
	    /tmp/xorshift64.dh /tmp/mwc64x.dh /tmp/parkmiller.dh \
	    /tmp/tauslcg.dh /tmp/tauslcg_xs1.dh

docs:
	@ls docs/*.md

install:
	$(PY) -m pip install -e .

clean:
	rm -rf build dist *.egg-info cl_ops_tpu/native/*.so .jax_cache
