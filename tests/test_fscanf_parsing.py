"""The reference tools load patterns/BEDs with fixed-format fscanf
loops (`"%255s%d%d%255s %c %c%127s%127s"` — vaf-counter.c:164,
ed-vaf-counter.c:62; `"%254s%d%d%254s %c %c"` — snp-pattern-gen.c:271).
Those semantics differ from line-based splitting: tokens flow across
newlines, width caps split long tokens mid-token (the tail feeds the
next directive), `%c` can take the second char of a multi-char token,
and the first failed directive drops every later record.  These tests
pin our readers to the C binaries on inputs that exercise each quirk."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, "tests", "refbin")
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _need(tool):
    """Canonical shared oracle build (tests/oracles.py) — one recipe per
    tool repo-wide, so the tests/refbin binary is flag-identical no
    matter which test module builds it first."""
    from tests import oracles

    try:
        return oracles.ensure(tool)
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))


def _read(p):
    with open(p, "rb") as f:
        return f.read()


def _reads_fq(tmp_path, g, n=30, L=80, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i in range(n):
            st = int(rng.integers(0, max(len(g) - L, 1)))
            f.write(f"@r{i}\n{g[st:st+L]}\n+\n{'I'*L}\n")
        # guaranteed coverage of the pattern sites used by these tests
        for j, st in enumerate((90, 95, 290, 295)):
            f.write(f"@c{j}\n{g[st:st+L]}\n+\n{'I'*L}\n")
    return fq


DIRTY_PATTERNS = (
    # record split across lines: fscanf tokens flow over newlines
    "chr1\t10\n11\trsA\nA\tC\n{r21}\n{a21}\n"
    # multi-char ref token: ref='G', alt='T' from ONE token "GT", and
    # the ref k-mer then starts at the token's third char
    "chr2 20 21 rsB GT{r21b} {a21b}\n"
    # 129-base k-mer: %127s splits it; the 2-char tail becomes the alt
    # k-mer and the real alt k-mer becomes the next record's chr, whose
    # %d then fails on 'rsC' -> every later record is dropped
    "chr3 30 31 rsC A C {r129} {a129}\n"
    "chr4 40 41 rsD A C {r21} {a21}\n"
)


def _mk_pattern_file(tmp_path, g):
    r21 = g[100:121]
    a21 = r21[:10] + ("A" if r21[10] != "A" else "C") + r21[11:]
    r21b = g[300:321]
    a21b = r21b[:10] + ("G" if r21b[10] != "G" else "T") + r21b[11:]
    r129 = g[500:629]
    a129 = r129[:64] + ("A" if r129[64] != "A" else "C") + r129[65:]
    pat = str(tmp_path / "dirty.pat")
    with open(pat, "w") as f:
        f.write(DIRTY_PATTERNS.format(
            r21=r21, a21=a21, r21b=r21b, a21b=a21b, r129=r129, a129=a129))
    return pat


@pytest.fixture()
def genome():
    import numpy as np

    rng = np.random.default_rng(17)
    return "".join(np.random.default_rng(17).choice(list("ACGT"), size=4000))


@pytest.mark.parametrize("max_e", [0, 2])
def test_ed_vaf_fscanf_quirks(tmp_path, genome, max_e):
    ref = _need("ed-vaf-counter")
    pat = _mk_pattern_file(tmp_path, genome)
    fq = _reads_fq(tmp_path, genome)
    subprocess.run(
        [ref, "-p", pat, "-o", str(tmp_path / "ref.vaf"), "-e", str(max_e), fq],
        capture_output=True, check=True)
    from kmer_tpu.tools.ed_vaf_counter import main

    assert not main(["-p", pat, "-o", str(tmp_path / "our.vaf"),
                     "-e", str(max_e), fq])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


def test_vaf_counter_fscanf_quirks(tmp_path, genome):
    ref = _need("vaf-counter")
    pat = _mk_pattern_file(tmp_path, genome)
    fq = _reads_fq(tmp_path, genome)
    subprocess.run(
        [ref, "-k21", "-p", pat, "-o", str(tmp_path / "ref.vaf"), fq],
        capture_output=True, check=True)
    from kmer_tpu.tools.vaf_counter import main

    assert not main(["-k21", "-p", pat, "-o", str(tmp_path / "our.vaf"), fq])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


def test_unequal_kmer_lengths_use_ref_len(tmp_path, genome):
    """kmer_len is cached from strlen(ref_kmer) and reused for the alt
    search (ed-vaf-counter.c:77,143-146): a longer alt k-mer is
    truncated to the ref's length."""
    ref = _need("ed-vaf-counter")
    r21 = genome[100:121]
    # alt = ref's first 21 bases plus a tail: truncation makes it match
    # the REF sites exactly
    alt31 = r21 + genome[121:131]
    pat = str(tmp_path / "p.txt")
    with open(pat, "w") as f:
        f.write(f"chr1\t10\t11\trs0\tA\tC\t{r21}\t{alt31}\n")
    fq = _reads_fq(tmp_path, genome)
    subprocess.run(
        [ref, "-p", pat, "-o", str(tmp_path / "ref.vaf"), "-e", "0", fq],
        capture_output=True, check=True)
    from kmer_tpu.tools.ed_vaf_counter import main

    assert not main(["-p", pat, "-o", str(tmp_path / "our.vaf"), "-e", "0", fq])
    got = _read(tmp_path / "our.vaf")
    assert got == _read(tmp_path / "ref.vaf")
    # truncated alt == ref prefix: both columns must carry equal counts
    row = got.splitlines()[2].split(b"\t")
    assert row[5] == row[6] and int(row[5]) > 0


def test_int_overflow_matches_glibc(tmp_path):
    """%d on overflow: glibc saturates via strtol then casts to int —
    +overflow prints -1, -overflow prints 0 (verified vs the oracle)."""
    ref = _need("ed-vaf-counter")
    pat = str(tmp_path / "p.txt")
    km = "ACGTACGTACGTACGTACGTA"
    with open(pat, "w") as f:
        f.write(f"chr1\t99999999999999999999\t5\trs0\tA\tC\t{km}\t{km}\n")
        f.write(f"chr1\t-99999999999999999999\t6\trs1\tA\tC\t{km}\t{km}\n")
        f.write(f"chr1\t5000000000\t7\trs2\tA\tC\t{km}\t{km}\n")
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        f.write("@r0\nACGT\n+\nIIII\n")
    subprocess.run(
        [ref, "-p", pat, "-o", str(tmp_path / "ref.vaf"), "-e", "0", fq],
        capture_output=True, check=True)
    from kmer_tpu.tools.ed_vaf_counter import main

    assert not main(["-p", pat, "-o", str(tmp_path / "our.vaf"), "-e", "0", fq])
    got = _read(tmp_path / "our.vaf")
    assert got == _read(tmp_path / "ref.vaf")
    assert b"\t-1\t" in got and b"\t0\trs1\t" in got


def test_snp_pattern_gen_bed_fscanf_quirks(tmp_path, genome):
    ref = _need("snp-pattern-gen")
    fa = str(tmp_path / "g.fa")
    with open(fa, "w") as f:
        f.write(f">chr1\n{genome}\n")
    bed = str(tmp_path / "s.bed")
    with open(bed, "w") as f:
        # record split across lines + multi-char ref token ("AC" ->
        # ref='A', alt='C') + a non-numeric field that ends the load
        f.write("chr1\t100\n101\trs0\n" + genome[100] + "\t"
                + ("A" if genome[100] != "A" else "C") + "\n")
        f.write(f"chr1 200 201 rs1 {genome[200]}G\n")
        f.write("chr1 oops 301 rs2 A C\n")
        f.write(f"chr1 400 401 rs3 {genome[400]} T\n")
    for args in (["-k21"], ["-k31"]):
        subprocess.run(
            [ref, *args, "-b", bed, "-f", fa,
             "-o", str(tmp_path / "ref.pat")],
            capture_output=True, check=True)
        from kmer_tpu.tools.snp_pattern_gen import main

        assert not main([*args, "-b", bed, "-f", fa,
                         "-o", str(tmp_path / "our.pat")])
        assert _read(tmp_path / "our.pat") == _read(tmp_path / "ref.pat")
