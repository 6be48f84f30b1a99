# Workflow targets (the package.json scripts analog, package.json:5-11)

.PHONY: dev api start build test test-quick test-gpu bench suite chip-smoke native cuda clean

dev:            ## headless app with orbiting camera
	python apps/main.py --orbit

api:            ## artifact dump API sidecar on :3000
	python -m raytracer.server.api

start:          ## static viewer server on :3000
	python -m raytracer.server.static

native:         ## build bin/bvh_convert + lib/libbvhtool.so
	raytracer/native/build.sh

cuda:           ## build the CUDA traversal kernel into lib/ (needs nvcc)
	python -m raytracer.ops.cuda_trace

native-bench:   ## 100x converter loop (test.sh analog)
	raytracer/native/bench.sh

test:            ## full suite on the CPU (virtual 8-device mesh)
	python -m pytest tests/ -x -q

test-quick:      ## fast tier only (skips tests marked 'full')
	python -m pytest tests/ -x -q -m "not full"

test-gpu:        ## the tests that need the card, on a machine with a GPU
	RAYTRACER_TEST_GPU=1 python -m pytest tests/ -q -m gpu

bench:           ## dragon-class 1080p headline on the GPU (fails without one)
	python bench.py

suite:           ## the five BASELINE configurations on the GPU
	python bench_suite.py

chip-smoke:      ## end-to-end smoke + kernel parity + kernel-vs-XLA on one GPU
	python chip_smoke.py

clean:
	rm -rf bin lib data/*.bin data/*.png .pytest_cache .jax_cache
