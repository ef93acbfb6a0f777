"""kmer_tpu — a JAX k-mer counting and SNP-fingerprinting engine.

A from-scratch JAX/XLA re-design of the capabilities of
gerbenvoshol/kmer-cnt (lh3/kmer-cnt counters + NGSCheckMate-style SNP
sample-identity pipeline).  The compute path is vectorized JAX running
on the accelerator (2-bit base codes as uint32 hi/lo planes, sort-based
count engines, blocked bloom filters, Myers bit-vector edit distance);
the runtime around it (FASTA/FASTQ ingest, pipelining, file formats)
lives on the host.

Reference parity targets (cited per-module as /root/reference/<file>:<line>):
  kc-py1, kc-cpp1/2, kc-c1..c4, yak-count     -> kmer_tpu.tools.kc / yak_count
  snp-pattern-gen, vaf-counter, ed-vaf-counter,
  bam-vaf-counter, vcf-vaf-counter            -> kmer_tpu.tools.*
  correlation-matrix, match-classifier        -> kmer_tpu.tools.*
"""

__version__ = "0.1.0"

import os as _os

# Persistent compilation cache: the CLI tools are separate processes and
# the count/bloom programs take seconds to compile; caching makes every
# invocation after the first start quickly (host analog of the
# reference's ahead-of-time compiled binaries).  Configured via env vars
# (read by jax.config at import) so that host-only tools — bam/vcf-vaf-
# counter, correlation-matrix, match-classifier — never pay the
# `import jax` cost.
#
# JAX_COMPILATION_CACHE_DIR, when set, is used as is.  Otherwise the
# cache lives at a fixed path inside the checkout (.jax_cache/, git-
# ignored), so every process of a checkout shares it.  CPU programs are
# host machine code: they go to a subdirectory keyed by the host CPU's
# feature flags, so a cache that travels with a checkout never loads an
# executable built for another CPU.
import os as _os
import sys as _sys

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _cpu_fingerprint() -> str:
    """Short stable id of this host's CPU feature set."""
    try:
        import hashlib

        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(
                        " ".join(sorted(line.split()))
                        .encode()).hexdigest()[:10]
    except OSError:
        pass
    return "unknown"


def _cache_dir() -> str:
    plat = _os.environ.get("JAX_PLATFORMS", "")
    if not plat and "jax" in _sys.modules:
        try:
            plat = _sys.modules["jax"].config.jax_platforms or ""
        except AttributeError:
            plat = ""
    base = _os.path.join(_CHECKOUT, ".jax_cache")
    if plat.split(",")[0].strip() == "cpu":
        return _os.path.join(base, "cpu_" + _cpu_fingerprint())
    return base


if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache_dir()
    # the env var only applies at jax import; when something imported
    # jax before us (bench.py, the test suite), apply the config directly
    if "jax" in _sys.modules:
        _sys.modules["jax"].config.update(
            "jax_compilation_cache_dir",
            _os.environ["JAX_COMPILATION_CACHE_DIR"])
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")
_os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
if "jax" in _sys.modules:
    _sys.modules["jax"].config.update(
        "jax_persistent_cache_min_compile_time_secs",
        float(_os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))
    _sys.modules["jax"].config.update(
        "jax_persistent_cache_min_entry_size_bytes",
        int(_os.environ["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"]))
