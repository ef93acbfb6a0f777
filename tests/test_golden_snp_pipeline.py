"""Golden parity for the full SNP-fingerprinting pipeline:
snp-pattern-gen -> vaf-counter -> correlation-matrix -> match-classifier,
every intermediate file diffed byte-for-byte against the C reference
(EXAMPLE.md's 5-step walkthrough as an automated test)."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, "tests", "refbin")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BED = os.path.join(FIXTURES, "snps_small.bed")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")
SAMPLES = ["sampleA1", "sampleA2", "sampleB"]

@pytest.fixture(scope="session")
def refbin():
    """Build via the one canonical recipe table (tests/oracles.py)."""
    from tests import oracles

    try:
        return oracles.ensure_all(
            ["snp-pattern-gen", "vaf-counter", "correlation-matrix",
             "match-classifier"])
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))


def run_ref(refbin, tool, args):
    subprocess.run([os.path.join(refbin, tool)] + args, capture_output=True, check=True)


def run_ours(tool, args):
    from kmer_tpu.tools import get_tool

    assert not get_tool(tool)(args)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# the pipeline's count-engine consumers (snp-pattern-gen's genome scan,
# vaf-counter's read counting) run on both the single-device engine and
# the 8-virtual-device mesh through the CLI entry points
@pytest.fixture(params=["single", "mesh"])
def engine_mode(request, monkeypatch):
    monkeypatch.setenv("KMER_TPU_FORCE_MESH",
                       "1" if request.param == "mesh" else "0")
    return request.param


def test_full_pipeline_parity(refbin, tmp_path, engine_mode):
    d = str(tmp_path)

    # step 1: snp-pattern-gen
    run_ref(refbin, "snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", f"{d}/ref.pat"])
    run_ours("snp-pattern-gen", ["-k21", "-b", BED, "-f", GENOME, "-o", f"{d}/our.pat"])
    assert _read(f"{d}/our.pat") == _read(f"{d}/ref.pat")

    # step 2: vaf-counter per sample
    for s in SAMPLES:
        fq = os.path.join(FIXTURES, f"{s}.fq.gz")
        run_ref(refbin, "vaf-counter", ["-k21", "-p", f"{d}/ref.pat", "-o", f"{d}/ref_{s}.vaf", fq])
        run_ours("vaf-counter", ["-k21", "-p", f"{d}/our.pat", "-o", f"{d}/our_{s}.vaf", fq])
        assert _read(f"{d}/our_{s}.vaf") == _read(f"{d}/ref_{s}.vaf"), s

    # step 3: correlation-matrix (+ tree)
    ref_vafs = [f"{d}/ref_{s}.vaf" for s in SAMPLES]
    our_vafs = [f"{d}/our_{s}.vaf" for s in SAMPLES]
    run_ref(refbin, "correlation-matrix", ["-o", f"{d}/ref.corr", "-t"] + ref_vafs)
    run_ours("correlation-matrix", ["-o", f"{d}/our.corr", "-t"] + our_vafs)
    # sample names come from the VAF filenames; normalize the prefix
    ref_corr = _read(f"{d}/ref.corr").replace(b"ref_", b"")
    our_corr = _read(f"{d}/our.corr").replace(b"our_", b"")
    assert our_corr == ref_corr
    assert _read(f"{d}/our.tree").replace(b"our_", b"") == _read(
        f"{d}/ref.tree"
    ).replace(b"ref_", b"")

    # step 4: match-classifier — fixed threshold and predefined model
    run_ref(refbin, "match-classifier", ["-c", f"{d}/ref.corr", "-o", f"{d}/ref.m1", "-v"])
    run_ours("match-classifier", ["-c", f"{d}/our.corr", "-o", f"{d}/our.m1", "-v"])
    assert _read(f"{d}/our.m1").replace(b"our_", b"") == _read(f"{d}/ref.m1").replace(b"ref_", b"")

    run_ref(
        refbin,
        "match-classifier",
        ["-c", f"{d}/ref.corr", "-o", f"{d}/ref.m2", "-v", "-P"] + ref_vafs,
    )
    run_ours(
        "match-classifier",
        ["-c", f"{d}/our.corr", "-o", f"{d}/our.m2", "-v", "-P"] + our_vafs,
    )
    assert _read(f"{d}/our.m2").replace(b"our_", b"") == _read(f"{d}/ref.m2").replace(b"ref_", b"")

    # sanity: the pipeline found the replicate pair
    assert b"MATCHED" in _read(f"{d}/our.m2")

    # correlation preset modes (-M) and explicit -m/-d overrides
    for mode_args in (["-M", "matched"], ["-M", "strict"], ["-m", "5", "-d", "2"]):
        run_ref(refbin, "correlation-matrix",
                ["-o", f"{d}/ref.mc"] + mode_args + ref_vafs)
        run_ours("correlation-matrix",
                 ["-o", f"{d}/our.mc"] + mode_args + our_vafs)
        assert _read(f"{d}/our.mc").replace(b"our_", b"") == _read(
            f"{d}/ref.mc"
        ).replace(b"ref_", b""), mode_args

    # trained-threshold mode (-T): known matched pair -> midpoint threshold
    with open(f"{d}/ref.pairs", "w") as f:
        f.write(f"ref_{SAMPLES[0]}\tref_{SAMPLES[1]}\n")
    with open(f"{d}/our.pairs", "w") as f:
        f.write(f"our_{SAMPLES[0]}\tour_{SAMPLES[1]}\n")
    run_ref(refbin, "match-classifier",
            ["-c", f"{d}/ref.corr", "-o", f"{d}/ref.m3", "-v", "-T", f"{d}/ref.pairs"])
    run_ours("match-classifier",
             ["-c", f"{d}/our.corr", "-o", f"{d}/our.m3", "-v", "-T", f"{d}/our.pairs"])
    assert _read(f"{d}/our.m3").replace(b"our_", b"") == _read(
        f"{d}/ref.m3"
    ).replace(b"ref_", b"")

    # family mode (-P -F)
    run_ref(refbin, "match-classifier",
            ["-c", f"{d}/ref.corr", "-o", f"{d}/ref.m4", "-v", "-P", "-F"] + ref_vafs)
    run_ours("match-classifier",
             ["-c", f"{d}/our.corr", "-o", f"{d}/our.m4", "-v", "-P", "-F"] + our_vafs)
    assert _read(f"{d}/our.m4").replace(b"our_", b"") == _read(
        f"{d}/ref.m4"
    ).replace(b"ref_", b"")


@pytest.mark.parametrize("min_depth", [0, 1, 5])
def test_correlation_unequal_sample_lengths(refbin, tmp_path, min_depth):
    """VAF files with DIFFERENT row counts: the reference pairs sample
    i's rows with fresh-mmap zero pages past sample j's count
    (malloc'd MAX_SNPS arrays, correlation-matrix.c:45-46,155), so
    -d >= 1 excludes the tail while -d 0 includes it with vaf 0.0 —
    both must be byte-identical (regression: truncating to the common
    length broke -d 0, crashing broke everything)."""
    import random

    random.seed(7)
    vafs = []
    for si, n in enumerate((50, 100, 80)):
        p = str(tmp_path / f"s{si}.vaf")
        with open(p, "w") as f:
            f.write("# Average depth: 10.00\n")
            f.write("#CHR\tPOS\tRSID\tREF\tALT\tREF_COUNT\tALT_COUNT"
                    "\tTOTAL_COUNT\tVAF\n")
            for i in range(n):
                rc, ac = random.randint(0, 20), random.randint(0, 20)
                t = rc + ac
                vaf = (ac / t) if t else 0.0
                f.write(f"chr1\t{1000 + i}\trs{i}\tA\tC\t{rc}\t{ac}\t{t}"
                        f"\t{vaf:.4f}\n")
        vafs.append(p)
    d = str(tmp_path)
    run_ref(refbin, "correlation-matrix",
            ["-d", str(min_depth), "-o", f"{d}/ref.corr"] + vafs)
    run_ours("correlation-matrix",
             ["-d", str(min_depth), "-o", f"{d}/our.corr"] + vafs)
    assert _read(f"{d}/our.corr") == _read(f"{d}/ref.corr")
