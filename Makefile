# kmer_tpu build / test / bench conveniences.
#
# The Python package needs no build step; `native` compiles the C++
# FASTA/FASTQ reader (kmer_tpu/io/native/) ahead of time — otherwise it
# is built on demand at first use with the same flags.

PY ?= python3

.PHONY: all native test test-fast test-gpu bench chip-smoke fixtures oracles htslib panels clean

all: native

native: kmer_tpu/io/native/libkmerio.so

# -DKTP_HAVE_LIBDEFLATE/-ldeflate when the header is present (2.5x
# faster gzip decode; zlib streaming otherwise) — keep in sync with
# kmer_tpu/io/native/__init__.py:_build
DEFLATE := $(shell test -e /usr/include/libdeflate.h && echo 1)
DEFLATE_CPPFLAGS := $(if $(DEFLATE),-DKTP_HAVE_LIBDEFLATE,)
DEFLATE_LIBS := $(if $(DEFLATE),-ldeflate,)

kmer_tpu/io/native/libkmerio.so: kmer_tpu/io/native/fastx_reader.cpp kmer_tpu/io/native/bam_count.cpp kmer_tpu/io/native/cram_rans.cpp
	g++ -O3 $(DEFLATE_CPPFLAGS) -shared -fPIC -o $@ $^ -lz $(DEFLATE_LIBS)

test:
	$(PY) -m pytest tests/ -q

# unit + kernel tests only (skips the golden-oracle builds)
test-fast:
	$(PY) -m pytest tests/test_kernels.py tests/test_compactor.py \
	  tests/test_count_table.py tests/test_sharded.py -q

bench:
	$(PY) bench.py

# the GPU-only tests (skip on a CPU-only host)
test-gpu:
	$(PY) -m pytest tests/ -q -m gpu

# the main path on one GPU against numpy and the CPU backend
# (chip_smoke.py --four-cards: the mesh path on four GPUs)
chip-smoke:
	$(PY) chip_smoke.py

fixtures:
	$(PY) scripts/make_fixtures.py

# every reference oracle binary for the golden tests (tests/refbin/),
# including the htslib-linked ones — builds the htslib static lib
# itself on first use (tests/oracles.py ensure_htslib)
oracles:
	$(PY) -c "from tests import oracles; \
	  oracles.ensure_all(list(oracles.RECIPES) \
	    + list(oracles.HTSLIB_RECIPES) + list(oracles.SUPPORT_RECIPES))"

# just the htslib static lib (/tmp/htslib_build, ~1-4 min once)
htslib:
	$(PY) -c "from tests import oracles; print(oracles.ensure_htslib())"

panels:
	$(PY) scripts/fetch_snp_panels.py

clean:
	rm -f kmer_tpu/io/native/libkmerio.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
