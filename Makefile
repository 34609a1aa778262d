# Development targets (parity with the reference's Makefile: test/bench/check)

PY ?= python

.PHONY: test test-fast bench bench-all check clean native

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -x -q

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench.py --all

check:
	$(PY) -m compileall -q comet_tpu
	$(PY) -m pytest tests/ -q

native:
	cc -O3 -shared -fPIC comet_tpu/native/*.c -o comet_tpu/native/_comet_native.so

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
	rm -rf .pytest_cache
