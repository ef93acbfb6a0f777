"""Golden parity for the alternative VAF producers: ed-vaf-counter
(Myers/edlib), bam-vaf-counter (alignment positions), vcf-vaf-counter
(genotypes) — each diffed against its compiled C reference when the
reference binary is available (bam/vcf need an htslib build; see
.claude/skills/verify/SKILL.md)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, "tests", "refbin")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
BED = os.path.join(FIXTURES, "snps_small.bed")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")


@pytest.fixture(scope="module")
def patterns(tmp_path_factory):
    """Reference pattern file (built by the reference tool when present,
    else by ours — both are parity-tested elsewhere)."""
    d = tmp_path_factory.mktemp("pat")
    out = str(d / "patterns.txt")
    ref = os.path.join(REFBIN, "snp-pattern-gen")
    if os.path.exists(ref):
        subprocess.run(
            [ref, "-k21", "-b", BED, "-f", GENOME, "-o", out],
            capture_output=True,
            check=True,
        )
    else:
        from kmer_tpu.tools.snp_pattern_gen import main

        assert not main(["-k21", "-b", BED, "-f", GENOME, "-o", out])
    return out


def _need(tool):
    """Build the oracle on demand (including the htslib static lib for
    bam/vcf — tests/oracles.py ensure_htslib); skip only when the build
    itself is impossible on this box."""
    from tests import oracles

    try:
        return oracles.ensure(tool)
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))


def _ensure_sam():
    """The SAM text fixture is generated, not committed (2.7 MB); on a
    fresh checkout regenerate it deterministically into a scratch dir
    (so the git-tracked .gz fixtures keep their committed bytes — gzip
    stamps mtime) and copy just the .sam over."""
    sam = os.path.join(FIXTURES, "sampleA_aln.sam")
    if not os.path.exists(sam):
        import shutil
        import subprocess
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            r = subprocess.run(
                [sys.executable,
                 os.path.join(REPO, "scripts", "make_fixtures.py"), td],
                capture_output=True,
            )
            if r.returncode != 0:
                pytest.skip(f"cannot generate SAM fixture: {r.stderr.decode()}")
            shutil.copy(os.path.join(td, "sampleA_aln.sam"), sam)
    return sam


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("max_e", [0, 1])
def test_ed_vaf_parity(patterns, tmp_path, max_e):
    ref = _need("ed-vaf-counter")
    fq = os.path.join(FIXTURES, "sampleA1.fq.gz")
    # a pattern subset keeps the O(reads x patterns) reference fast
    sub = str(tmp_path / "sub.txt")
    with open(patterns) as f, open(sub, "w") as g:
        for i, line in enumerate(f):
            if i >= 64:
                break
            g.write(line)
    subprocess.run(
        [ref, "-p", sub, "-o", str(tmp_path / "ref.vaf"), "-e", str(max_e), fq],
        capture_output=True,
        check=True,
    )
    from kmer_tpu.tools.ed_vaf_counter import main

    assert not main(["-p", sub, "-o", str(tmp_path / "our.vaf"), "-e", str(max_e), fq])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


@pytest.mark.parametrize("max_e", [0, 1, 2])
def test_ed_vaf_byte_exact_alphabet(tmp_path, max_e):
    """edlib compares RAW bytes — no case folding, and 'N' == 'N'
    (edlib.cpp:1417 alphabet transform).  A lowercase read copy must
    NOT match an uppercase pattern, and an N in a read must match a
    pattern N; the former SEQ_NT4 case-folding encode diverged on
    both (regression)."""
    ref = _need("ed-vaf-counter")
    pat = str(tmp_path / "pat.txt")
    with open(pat, "w") as f:
        f.write("chr1\t100\t101\trs1\tA\tC\t"
                "ACGTACGTACGTACGTACGTA\tACGTACGTACCTACGTACGTA\n")
        f.write("chr1\t200\t201\trs2\tG\tT\t"
                "GGGGGNGGGGGGGGGGGGGGG\tGGGGGNGGGGTGGGGGGGGGG\n")
    fq = str(tmp_path / "r.fq.gz")
    import gzip

    with gzip.open(fq, "wb") as f:
        for i, r in enumerate([
            b"ACGTACGTACGTACGTACGTAGGG",   # exact ref1
            b"acgtacgtacgtacgtacgta",      # lowercase: must not match
            b"TTGGGGGNGGGGGGGGGGGGGGGTT",  # read N == pattern N
            b"ACGTACGTACCTACGTACGTA",      # alt1
        ]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    subprocess.run(
        [ref, "-p", pat, "-o", str(tmp_path / "ref.vaf"),
         "-e", str(max_e), fq],
        capture_output=True, check=True,
    )
    from kmer_tpu.tools.ed_vaf_counter import main

    assert not main(["-p", pat, "-o", str(tmp_path / "our.vaf"),
                     "-e", str(max_e), fq])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


def test_bam_vaf_parity_indexed_and_sequential(patterns, tmp_path):
    ref = _need("bam-vaf-counter")
    bam = os.path.join(FIXTURES, "sampleA_aln.bam")
    if not os.path.exists(bam):
        pytest.skip("BAM fixture missing")
    from kmer_tpu.tools.bam_vaf_counter import main

    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref.vaf"), bam],
        capture_output=True,
        check=True,
    )
    assert not main(["-p", patterns, "-o", str(tmp_path / "our.vaf"), bam])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")

    # sequential fallback: copy without the .bai
    import shutil

    noidx = str(tmp_path / "noidx.bam")
    shutil.copy(bam, noidx)
    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref2.vaf"), noidx],
        capture_output=True,
        check=True,
    )
    assert not main(["-p", patterns, "-o", str(tmp_path / "our2.vaf"), noidx])
    assert _read(tmp_path / "our2.vaf") == _read(tmp_path / "ref2.vaf")


def test_bam_native_vs_python_sequential(patterns, tmp_path, monkeypatch):
    """The C++ sequential scanner (io/native/bam_count.cpp) and the
    pure-Python BamReader loop must produce identical VAF files; also
    round-trips the fixture SAM through io/bamwrite.sam_to_bam so the
    binary readers see a BAM we constructed ourselves."""
    sam = _ensure_sam()
    from kmer_tpu.io import native
    from kmer_tpu.io.bamwrite import sam_to_bam
    from kmer_tpu.tools.bam_vaf_counter import main

    bam = str(tmp_path / "rt.bam")  # no .bai -> sequential scan
    sam_to_bam(sam, bam)
    assert not main(["-p", patterns, "-o", str(tmp_path / "a.vaf"), bam])
    monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    assert not main(["-p", patterns, "-o", str(tmp_path / "b.vaf"), bam])
    monkeypatch.delenv("KMER_TPU_NO_NATIVE")
    assert _read(tmp_path / "a.vaf") == _read(tmp_path / "b.vaf")
    # the SAM text path must agree with the BAM round-trip too
    assert not main(["-p", patterns, "-o", str(tmp_path / "c.vaf"), sam])
    assert _read(tmp_path / "c.vaf") == _read(tmp_path / "a.vaf")
    if native.available():
        ref = _need("bam-vaf-counter")
        subprocess.run(
            [ref, "-p", patterns, "-o", str(tmp_path / "ref.vaf"), bam],
            capture_output=True,
            check=True,
        )
        assert _read(tmp_path / "a.vaf") == _read(tmp_path / "ref.vaf")


def test_bai_writer_indexed_parity(patterns, tmp_path):
    """A BAM we coordinate-sort + index ourselves (io/bamwrite.write_bai)
    must yield identical VAF via: our indexed path, our sequential path
    (index hidden), and the reference binary reading our .bai."""
    sam = _ensure_sam()
    from kmer_tpu.io.bamwrite import sam_to_bam, write_bai
    from kmer_tpu.tools.bam_vaf_counter import main

    bam = str(tmp_path / "sorted.bam")
    sam_to_bam(sam, bam, sort=True)
    write_bai(bam, bam + ".bai")
    assert not main(["-p", patterns, "-o", str(tmp_path / "idx.vaf"), bam])
    noidx = str(tmp_path / "noidx.bam")
    import shutil

    shutil.copy(bam, noidx)
    assert not main(["-p", patterns, "-o", str(tmp_path / "seq.vaf"), noidx])
    # NOTE: idx.vaf and seq.vaf deliberately differ on this dense panel —
    # the reference's indexed mode re-fetches a read once per merged
    # region it overlaps and counts ALL its SNPs each time
    # (bam-vaf-counter.c:303-317 runs per fetched read), so reads
    # spanning several regions are multi-counted.  We reproduce that
    # mode-for-mode; the assertions below pin parity per mode.
    ref = _need("bam-vaf-counter")
    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref.vaf"), bam],
        capture_output=True,
        check=True,
    )
    assert _read(tmp_path / "idx.vaf") == _read(tmp_path / "ref.vaf")
    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "refseq.vaf"), noidx],
        capture_output=True,
        check=True,
    )
    assert _read(tmp_path / "seq.vaf") == _read(tmp_path / "refseq.vaf")


def test_csi_writer_indexed_parity(patterns, tmp_path):
    """A BAM indexed with a .csi ONLY (no .bai; io/bamwrite.write_csi)
    must take the indexed path — htslib tries fn.bam.csi before any
    .bai (hts_idx_check_local, hts.c:4745-4760), and indexed mode is
    observable output (multi-counted overlapped regions, PARITY.md
    divergence 7) — and match: our .bai indexed run and the reference
    binary reading the same .csi.  Also exercised at a non-default
    geometry (min_shift=12, depth=6): same record sets, so same VAF."""
    sam = _ensure_sam()
    from kmer_tpu.io.bamwrite import sam_to_bam, write_bai, write_csi
    from kmer_tpu.tools.bam_vaf_counter import main

    bam = str(tmp_path / "sorted.bam")
    sam_to_bam(sam, bam, sort=True)
    write_csi(bam, bam + ".csi")
    assert not main(["-p", patterns, "-o", str(tmp_path / "csi.vaf"), bam])
    ref = _need("bam-vaf-counter")
    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref.vaf"), bam],
        capture_output=True,
        check=True,
    )
    assert _read(tmp_path / "csi.vaf") == _read(tmp_path / "ref.vaf")
    # cross-check vs the .bai indexed path on a separate copy (identical
    # merged regions -> identical indexed-mode VAF)
    import shutil

    bam2 = str(tmp_path / "sorted2.bam")
    shutil.copy(bam, bam2)
    write_bai(bam2, bam2 + ".bai")
    assert not main(["-p", patterns, "-o", str(tmp_path / "bai.vaf"), bam2])
    assert _read(tmp_path / "csi.vaf") == _read(tmp_path / "bai.vaf")
    # non-default binning geometry must produce the same record sets
    bam3 = str(tmp_path / "sorted3.bam")
    shutil.copy(bam, bam3)
    write_csi(bam3, bam3 + ".csi", min_shift=12, depth=6)
    assert not main(["-p", patterns, "-o", str(tmp_path / "csi2.vaf"), bam3])
    assert _read(tmp_path / "csi2.vaf") == _read(tmp_path / "csi.vaf")
    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref2.vaf"), bam3],
        capture_output=True,
        check=True,
    )
    assert _read(tmp_path / "csi2.vaf") == _read(tmp_path / "ref2.vaf")


def test_sam_text_vaf_parity(patterns, tmp_path):
    """Plain-text SAM input (the reference reads it via htslib sam_open;
    ours via io.bam.SamTextReader)."""
    ref = _need("bam-vaf-counter")
    sam = _ensure_sam()
    from kmer_tpu.tools.bam_vaf_counter import main

    subprocess.run(
        [ref, "-p", patterns, "-o", str(tmp_path / "ref.vaf"), sam],
        capture_output=True,
        check=True,
    )
    assert not main(["-p", patterns, "-o", str(tmp_path / "our.vaf"), sam])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


@pytest.mark.parametrize("ext", ["vcf", "bcf", "vcf.gz"])
def test_vcf_vaf_parity(patterns, tmp_path, ext):
    ref = _need("vcf-vaf-counter")
    vcf = os.path.join(FIXTURES, f"sampleA.{ext}")
    if not os.path.exists(vcf):
        pytest.skip(f"{ext} fixture missing")
    from kmer_tpu.tools.vcf_vaf_counter import main

    subprocess.run(
        [ref, "-p", patterns, "-v", vcf, "-o", str(tmp_path / "ref.vaf")],
        capture_output=True,
        check=True,
    )
    assert not main(["-p", patterns, "-v", vcf, "-o", str(tmp_path / "our.vaf")])
    assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf")


def test_ed_long_reads_and_patterns(tmp_path):
    """Reads beyond the old 1024 cap (length-bucketed batching) and
    patterns beyond the kernel's 32-base word (host multi-word Myers)
    must match reference edlib byte-for-byte."""
    ref = _need("ed-vaf-counter")
    import numpy as np

    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = acgt[rng.integers(0, 4, 30000)].tobytes().decode()
    pats = []
    for i, k in [(0, 21), (1, 41), (2, 33)]:
        pos = 3000 + i * 5000
        ref_km = g[pos - k // 2 : pos + k // 2 + 1]
        alt = "A" if g[pos] != "A" else "C"
        alt_km = ref_km[: k // 2] + alt + ref_km[k // 2 + 1 :]
        pats.append(
            f"chr1\t{pos}\t{pos + 1}\trs{i}\t{g[pos]}\t{alt}\t{ref_km}\t{alt_km}"
        )
    pat = str(tmp_path / "p.txt")
    with open(pat, "w") as f:
        f.write("\n".join(pats) + "\n")
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for r in range(20):
            # spans the 1024 and 4096 length buckets
            L = int(rng.integers(100, 3000))
            st = int(rng.integers(0, len(g) - L))
            f.write(f"@r{r}\n{g[st:st + L]}\n+\n{'I' * L}\n")
    from kmer_tpu.tools.ed_vaf_counter import main

    for e in (0, 2):
        subprocess.run(
            [ref, "-p", pat, "-o", str(tmp_path / "ref.vaf"), "-e", str(e), fq],
            capture_output=True,
            check=True,
        )
        assert not main(
            ["-p", pat, "-o", str(tmp_path / "our.vaf"), "-e", str(e), fq]
        )
        assert _read(tmp_path / "our.vaf") == _read(tmp_path / "ref.vaf"), e


@pytest.fixture(scope="module", params=["3.0", "3.1"])
def cram_fixture(request, tmp_path_factory):
    """BAM -> CRAM via htslib (scripts/sam2cram.c against the
    /tmp/htslib_build static lib, per .claude/skills/verify/SKILL.md);
    the uncompressed reference sits next to it so both the htslib
    oracle and our reader resolve it from the @SQ UR field.  Runs at
    both container versions: 3.0 (rANS 4x8 + gzip) and 3.1 (rANS Nx16
    + tok3 names, htscodecs rANS_static4x16pr.c / tokenise_name3.c)."""
    import gzip

    from tests import oracles

    try:
        conv = oracles.ensure("sam2cram")
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))
    d = tmp_path_factory.mktemp("cram")
    ref_fa = str(d / "genome.fa")
    with gzip.open(GENOME, "rb") as fin, open(ref_fa, "wb") as fout:
        fout.write(fin.read())
    cram = str(d / "sampleA.cram")
    subprocess.run(
        [conv, os.path.join(FIXTURES, "sampleA_aln.bam"), ref_fa, cram,
         f"v={request.param}"],
        capture_output=True, check=True,
    )
    return cram


@pytest.mark.parametrize("native", ["native", "python"])
def test_cram_records_match_bam(cram_fixture, monkeypatch, native):
    """Every decoded CRAM record must equal its BAM original: flags,
    tid, pos, CIGAR, and the full reference-reconstructed sequence
    (substitution matrix + feature list, kmer_tpu/io/cram.py) — through
    both the native rANS decoder (io/native/cram_rans.cpp) and its
    pure-Python twin."""
    if native == "python":
        monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    from kmer_tpu.io.bam import open_alignment
    from kmer_tpu.io.cram import CramReader

    bam = open_alignment(os.path.join(FIXTURES, "sampleA_aln.bam"))
    cram = CramReader(cram_fixture)
    n = 0
    for b, c in zip(bam.records(), cram.records()):
        assert (b.flag, b.tid, b.pos, b.l_seq) == (c.flag, c.tid, c.pos, c.l_seq)
        assert list(b.cigar) == list(c.cigar)
        assert all(b.base_at(j) == c.base_at(j) for j in range(b.l_seq))
        n += 1
    assert n == sum(1 for _ in open_alignment(
        os.path.join(FIXTURES, "sampleA_aln.bam")).records())


def test_rans_truncated_block_descriptive_error(monkeypatch):
    """A truncated/corrupt rANS block through the pure-Python decoder
    must raise the documented ValueError, not a bare IndexError from a
    freq-table peek (kmer_tpu/io/cram.py rans_decode)."""
    monkeypatch.setenv("KMER_TPU_NO_NATIVE", "1")
    from kmer_tpu.io.cram import rans_decode

    # order-0 header + in/out sizes, then a freq walk cut off mid-table
    blob = bytes([0]) + (100).to_bytes(4, "little") * 2 + bytes([65, 200])
    with pytest.raises(ValueError, match="rANS"):
        rans_decode(blob, 100)


def test_cram_vaf_parity(patterns, cram_fixture, tmp_path):
    """bam-vaf-counter on CRAM input, byte-identical to the htslib-backed
    reference on the same CRAM (bam-vaf-counter.c:24 via htslib cram/)."""
    ref = _need("bam-vaf-counter")
    d = str(tmp_path)
    subprocess.run(
        [ref, "-p", patterns, "-o", f"{d}/ref.vaf", cram_fixture],
        capture_output=True, check=True,
    )
    from kmer_tpu.tools.bam_vaf_counter import main

    assert not main(["-p", patterns, "-o", f"{d}/our.vaf", cram_fixture])
    assert _read(f"{d}/our.vaf") == _read(f"{d}/ref.vaf")


def test_cram_crai_indexed_parity(patterns, cram_fixture, tmp_path):
    """With a .crai present both implementations switch to indexed
    region fetching — including the reference's multi-count quirk for
    reads spanning several merged regions (PARITY.md divergence 7) —
    and must stay byte-identical."""
    ref = _need("bam-vaf-counter")
    conv = os.path.join(REFBIN, "sam2cram")
    # rebuild with an index next to a copy (cram_fixture has no .crai)
    d = str(tmp_path)
    import shutil

    cram = f"{d}/indexed.cram"
    shutil.copy(cram_fixture, cram)
    ref_fa = os.path.join(os.path.dirname(cram_fixture), "genome.fa")
    with open(cram_fixture, "rb") as fh:  # keep the fixture's version
        magic = fh.read(6)
    ver = f"v={magic[4]}.{magic[5]}"
    r = subprocess.run(
        [conv, os.path.join(FIXTURES, "sampleA_aln.bam"), ref_fa, cram,
         "index", ver],
        capture_output=True,
    )
    if r.returncode != 0 or not os.path.exists(cram + ".crai"):
        pytest.skip("sam2cram index build unavailable")
    subprocess.run(
        [ref, "-p", patterns, "-o", f"{d}/ref.vaf", cram],
        capture_output=True, check=True,
    )
    from kmer_tpu.tools.bam_vaf_counter import main

    assert not main(["-p", patterns, "-o", f"{d}/our.vaf", cram])
    assert _read(f"{d}/our.vaf") == _read(f"{d}/ref.vaf")
    # sanity: the indexed path actually diverges from sequential (the
    # fixture panel is dense), so this test is not vacuous
    subprocess.run(
        [ref, "-p", patterns, "-o", f"{d}/ref_seq.vaf", cram_fixture],
        capture_output=True, check=True,
    )
    assert _read(f"{d}/ref.vaf") != _read(f"{d}/ref_seq.vaf")


def test_cram31_fqz_records_match_bam(tmp_path):
    """A v3.1 CRAM written with CRAM_OPT_USE_FQZ carries method-7
    (fqzcomp) quality blocks (fqzcomp_qual.c) — every record must still
    equal its BAM original.  (USE_ARITH CRAMs cannot be produced by
    this box's bz2-less htslib oracle; the arith codec itself is
    golden-tested stream-level in test_cram31_codecs.py.)"""
    import gzip

    from tests import oracles

    try:
        conv = oracles.ensure("sam2cram")
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))
    ref_fa = str(tmp_path / "genome.fa")
    with gzip.open(GENOME, "rb") as fin, open(ref_fa, "wb") as fout:
        fout.write(fin.read())
    cram = str(tmp_path / "fqz.cram")
    subprocess.run(
        [conv, os.path.join(FIXTURES, "sampleA_aln.bam"), ref_fa, cram,
         "v=3.1", "fqz"],
        capture_output=True, check=True,
    )
    from kmer_tpu.io.bam import open_alignment
    from kmer_tpu.io.cram import CramReader

    bam = open_alignment(os.path.join(FIXTURES, "sampleA_aln.bam"))
    n = 0
    for b, c in zip(bam.records(), CramReader(cram).records()):
        assert (b.flag, b.tid, b.pos, b.l_seq) == (c.flag, c.tid, c.pos,
                                                   c.l_seq)
        assert all(b.base_at(j) == c.base_at(j) for j in range(b.l_seq))
        n += 1
    assert n == 8000
