#!/usr/bin/env python3
"""End-to-end parity fuzz: random adversarial FASTA/FASTQ vs the C
reference binaries (built in tests/refbin by the golden tests).

Generates inputs that stress edge cases — mixed/uniform read lengths,
reads shorter than k, N runs, lowercase, empty records, single-base
reads, multi-line FASTA — runs both implementations, and diffs stdout
byte-for-byte.

Usage: python scripts/fuzz_parity.py [rounds=20] [seed=0]
"""

import gzip
import io
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# JAX_PLATFORMS=cpu runs the fuzz's in-process tools on the CPU
# backend, as it does for the ktc launcher.

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, "tests", "refbin")


def random_fastx(rng, fastq=True):
    alpha = "ACGTacgtNnRYxUu"
    probs = np.array([12, 12, 12, 12, 2, 2, 2, 2, 3, 1, .5, .5, .5, .5, .5],
                     float)
    probs /= probs.sum()
    n_reads = int(rng.integers(1, 300))
    uniform = rng.random() < 0.4
    ulen = int(rng.integers(1, 260))
    out = io.StringIO()
    for i in range(n_reads):
        ln = ulen if uniform else int(rng.integers(0, 260))
        if rng.random() < 0.01:
            ln = 0  # empty sequence (with quality in FASTQ: kseq -2)
        seq = "".join(rng.choice(list(alpha), size=ln, p=probs))
        if fastq:
            qlen = ln
            if rng.random() < 0.03:
                # malformed quality length: kseq returns -2 (per-tool
                # stop/resume policies)
                qlen = int(rng.integers(0, ln + 40))
            out.write(f"@r{i} comment here\n{seq}\n+\n{'I' * qlen}\n")
            if rng.random() < 0.02:
                out.write("junk between records\n")
        else:
            out.write(f">r{i}\n")
            # multi-line FASTA with random wrap
            w = int(rng.integers(1, 80))
            for off in range(0, max(ln, 1), w):
                out.write(seq[off : off + w] + "\n")
            if rng.random() < 0.04:
                # '+' line inside FASTA: kseq switches to quality
                # consumption even for '>' records (kseq.h:222)
                out.write(f"+oops\n{'J' * int(rng.integers(0, ln + 20))}\n")
    return out.getvalue().encode()


def run_ref(tool, args):
    return subprocess.run(
        [os.path.join(REFBIN, tool)] + args, capture_output=True, check=True
    ).stdout


def run_ours(tool, args):
    import contextlib

    from kmer_tpu.tools import get_tool

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = get_tool(tool)(args)
    assert not rc, (tool, args)
    return buf.getvalue().encode()


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)
    fails = 0
    for t in range(rounds):
        data = random_fastx(rng, fastq=bool(rng.integers(0, 2)))
        gz = bool(rng.integers(0, 2))
        suffix = ".fq.gz" if gz else ".fq"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
            tf.write(gzip.compress(data) if gz else data)
            path = tf.name
        k = int(rng.choice([1, 2, 5, 15, 16, 17, 21, 31, 32]))
        cases = [("kc-c1", [f"-k{k}", path]), ("kc-c3", [f"-k{k}", path]),
                 ("kc-c4", [f"-k{k}", path]),
                 ("yak-count", [f"-k{k}", "-b14", path])]
        try:
            for tool, args in cases:
                want = run_ref(tool, args)
                got = run_ours(tool, args)
                if got != want:
                    fails += 1
                    print(f"[FAIL] round {t} {tool} {args}")
                    keep = f"/tmp/fuzz_fail_{t}{suffix}"
                    os.replace(path, keep)
                    print(f"       input kept at {keep}")
                    break
            else:
                print(f"[ok] round {t} k={k} ({len(data)} bytes)")
        finally:
            if os.path.exists(path):
                os.unlink(path)
    print(f"done: {rounds - fails}/{rounds} rounds clean")
    return 1 if fails else 0



def _ensure_cpp_oracles():
    from tests import oracles

    oracles.ensure_all(["kc-cpp1", "kc-cpp2"])


def _dirty_fastx(rng, fastq: bool, min_len: int) -> bytes:
    """Adversarial input for the raw-string baselines: lowercase and
    junk characters stay in keys, FASTQ parses as line-FASTA.  Records
    are either empty or >= min_len bases so the C++ originals' short-seq
    size_t-underflow abort (kc-cpp1.cpp:14) never triggers — that path
    is a reproduced-crash divergence, not a comparable output."""
    alpha = list("ACGTacgtNnRYxUu-")
    probs = np.array([12, 12, 12, 12, 4, 4, 4, 4, 3, 2, 1, 1, 1, 1, 1, 1],
                     float)
    probs /= probs.sum()
    out = io.StringIO()
    for i in range(int(rng.integers(1, 40))):
        ln = 0 if rng.random() < 0.05 else int(rng.integers(min_len, 300))
        seq = "".join(rng.choice(alpha, size=ln, p=probs))
        if fastq:
            # quality bytes avoid '>' (a quality line starting '>' is a
            # legal header to these line-based parsers — both sides
            # agree, but it can split off a short record -> C++ abort)
            qual = "".join(
                chr(c) for c in rng.integers(63, 74, ln)
            )
            out.write(f"@r{i} c\n{seq}\n+\n{qual}\n")
        else:
            out.write(f">r{i} desc\n")
            w = int(rng.integers(1, 80))
            for off in range(0, max(ln, 1), w):
                out.write(seq[off : off + w] + "\n")
    data = out.getvalue()
    if rng.random() < 0.3 and data.endswith("\n"):
        data = data[:-1]  # kc-py1 drops the last char of the final line
    return data.encode()


def fuzz_raw(rounds=10, seed=0):
    """Parity fuzz for the raw-string-keyed baselines (kc-py1, kc-cpp1,
    kc-cpp2) on dirty input vs the originals."""
    _ensure_cpp_oracles()
    import contextlib

    from kmer_tpu.tools import get_tool

    fails = 0
    for t in range(rounds):
        rng = np.random.default_rng(seed + 1000 * t)
        fastq = bool(rng.integers(0, 2))
        data = _dirty_fastx(rng, fastq, min_len=31)
        with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as tf:
            tf.write(data)
            path = tf.name
        k = int(rng.choice([0, 1, 5, 21, 31]))
        bad = None
        try:
            for tool in ("kc-cpp1", "kc-cpp2"):
                want = run_ref(tool, [f"-k{k}", path])
                got = run_ours(tool, [f"-k{k}", path])
                if got != want:
                    bad = tool
                    break
            if bad is None:
                want = subprocess.run(
                    [sys.executable, "/root/reference/kc-py1.py"],
                    input=data, capture_output=True, check=True,
                ).stdout
                old = sys.stdin
                sys.stdin = io.TextIOWrapper(io.BytesIO(data))
                try:
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = get_tool("kc-py1")([])
                    assert not rc
                finally:
                    sys.stdin = old
                if buf.getvalue().encode() != want:
                    bad = "kc-py1"
            if bad is not None:
                fails += 1
                keep = f"/tmp/fuzz_raw_fail_{t}.fa"
                os.replace(path, keep)
                print(f"[FAIL] raw round {t} {bad} k={k}; input at {keep}")
            else:
                print(f"[ok] raw round {t} k={k} fastq={fastq} "
                      f"({len(data)} bytes)")
        finally:
            if os.path.exists(path):
                os.unlink(path)
    print(f"raw done: {rounds - fails}/{rounds} clean")
    return fails


def fuzz_pipeline(rounds=5, seed=0):
    """Randomized full-pipeline parity: genome+BED -> snp-pattern-gen ->
    vaf-counter -> correlation-matrix -> match-classifier, diffed
    against the C binaries at every stage."""
    rng = np.random.default_rng(seed)
    fails = 0
    for t in range(rounds):
        k = int(rng.choice([11, 15, 21, 31]))
        with tempfile.TemporaryDirectory() as d:
            # genome: 2 chromosomes
            chroms = {}
            with open(f"{d}/g.fa", "w") as f:
                for ci in range(2):
                    ln = int(rng.integers(2000, 20000))
                    s = "".join(rng.choice(list("ACGT"), size=ln))
                    chroms[f"chr{ci+1}"] = s
                    f.write(f">chr{ci+1}\n{s}\n")
            # BED: random SNPs (some near edges, some duplicated pos)
            with open(f"{d}/s.bed", "w") as f:
                for si in range(int(rng.integers(10, 50))):
                    cn = f"chr{int(rng.integers(1, 3))}"
                    pos = int(rng.integers(0, len(chroms[cn])))
                    ref = chroms[cn][pos]
                    alt = rng.choice([c for c in "ACGT" if c != ref])
                    f.write(f"{cn}\t{pos}\t{pos+1}\trs{si}\t{ref}\t{alt}\n")
            args = ["-k" + str(k), "-b", f"{d}/s.bed", "-f", f"{d}/g.fa"]
            subprocess.run([os.path.join(REFBIN, "snp-pattern-gen")] + args
                           + ["-o", f"{d}/ref.pat"], capture_output=True, check=True)
            import contextlib
            from kmer_tpu.tools import get_tool
            with contextlib.redirect_stdout(io.StringIO()):
                rc = get_tool("snp-pattern-gen")(args + ["-o", f"{d}/our.pat"])
            assert not rc
            if open(f"{d}/our.pat").read() != open(f"{d}/ref.pat").read():
                print(f"[FAIL] round {t} snp-pattern-gen k={k}")
                fails += 1
                continue
            # reads: sample from genome with errors + some junk reads
            vafs = {"ref": [], "our": []}
            for s_i in range(2):
                with open(f"{d}/r{s_i}.fq", "w") as f:
                    for ri in range(int(rng.integers(50, 400))):
                        cn = f"chr{int(rng.integers(1, 3))}"
                        g = chroms[cn]
                        L = int(rng.integers(max(k, 30), 150))
                        st = int(rng.integers(0, max(len(g) - L, 1)))
                        read = list(g[st : st + L])
                        for _ in range(rng.poisson(0.5)):
                            read[int(rng.integers(0, len(read)))] = str(
                                rng.choice(list("ACGTN"))
                            )
                        f.write(f"@r{ri}\n{''.join(read)}\n+\n{'I'*len(read)}\n")
                va = ["-k" + str(k), "-p", f"{d}/ref.pat",
                      "-o", f"{d}/ref{s_i}.vaf", f"{d}/r{s_i}.fq"]
                subprocess.run([os.path.join(REFBIN, "vaf-counter")] + va,
                               capture_output=True, check=True)
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = get_tool("vaf-counter")(
                        ["-k" + str(k), "-p", f"{d}/ref.pat",
                         "-o", f"{d}/our{s_i}.vaf", f"{d}/r{s_i}.fq"])
                assert not rc
                if open(f"{d}/our{s_i}.vaf").read() != open(f"{d}/ref{s_i}.vaf").read():
                    print(f"[FAIL] round {t} vaf-counter sample {s_i} k={k}")
                    fails += 1
                    break
            else:
                # correlation + classifier
                subprocess.run(
                    [os.path.join(REFBIN, "correlation-matrix"), "-o",
                     f"{d}/ref.corr", f"{d}/ref0.vaf", f"{d}/ref1.vaf"],
                    capture_output=True, check=True)
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = get_tool("correlation-matrix")(
                        ["-o", f"{d}/our.corr", f"{d}/ref0.vaf", f"{d}/ref1.vaf"])
                assert not rc
                if open(f"{d}/our.corr").read() != open(f"{d}/ref.corr").read():
                    print(f"[FAIL] round {t} correlation-matrix")
                    fails += 1
                    continue
                # classifier: fixed threshold (-v keeps UNMATCHED rows
                # in the diff) and the NGSCheckMate predefined model
                # (-P reads depths back from the VAF headers)
                bad = False
                for mode in (["-v"], ["-P", "-v"]):
                    subprocess.run(
                        [os.path.join(REFBIN, "match-classifier"), "-c",
                         f"{d}/ref.corr", "-o", f"{d}/ref.match", *mode,
                         f"{d}/ref0.vaf", f"{d}/ref1.vaf"],
                        capture_output=True, check=True)
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = get_tool("match-classifier")(
                            ["-c", f"{d}/ref.corr", "-o", f"{d}/our.match",
                             *mode, f"{d}/ref0.vaf", f"{d}/ref1.vaf"])
                    assert not rc
                    if (open(f"{d}/our.match").read()
                            != open(f"{d}/ref.match").read()):
                        print(f"[FAIL] round {t} match-classifier {mode}")
                        fails += 1
                        bad = True
                        break
                if bad:
                    continue
                print(f"[ok] pipeline round {t} k={k}")
    print(f"pipeline done: {rounds - fails}/{rounds} clean")
    return fails


def fuzz_edvaf(rounds=10, seed=0):
    """Randomized ed-vaf-counter parity vs the compiled edlib reference:
    mixed short/long patterns (1- and multi-word Myers lanes in one
    batch), raw-byte alphabets (N, lowercase), read lengths spanning
    the 1024/4096 buckets, planted near-matches at every -e."""
    import contextlib

    from kmer_tpu.tools import get_tool

    fails = 0
    for t in range(rounds):
        rng = np.random.default_rng(seed + 7000 * t)
        with tempfile.TemporaryDirectory() as d:
            glen = int(rng.integers(4000, 20000))
            galpha = list("ACGT") + (["N", "a", "c"] if rng.random() < 0.4
                                     else [])
            g = "".join(rng.choice(galpha, size=glen))
            ks = rng.choice([5, 21, 31, 32, 33, 41, 63, 65, 97, 129],
                            size=int(rng.integers(1, 10)))
            with open(f"{d}/p.txt", "w") as f:
                for si, k in enumerate(ks):
                    k = int(k)
                    pos = int(rng.integers(k // 2, glen - k // 2 - 1))
                    ref_km = g[pos - k // 2 : pos - k // 2 + k]
                    ref = g[pos]
                    alt = str(rng.choice([c for c in "ACGT" if c != ref.upper()]))
                    alt_km = ref_km[: k // 2] + alt + ref_km[k // 2 + 1 :]
                    f.write(f"chr1\t{pos}\t{pos+1}\trs{si}\t{ref}\t{alt}\t"
                            f"{ref_km}\t{alt_km}\n")
            max_e = int(rng.integers(0, 4))
            with open(f"{d}/r.fq", "w") as f:
                for ri in range(int(rng.integers(5, 60))):
                    L = int(rng.integers(1, 3000))
                    st = int(rng.integers(0, max(glen - L, 1)))
                    read = list(g[st : st + L])
                    for _ in range(rng.poisson(1.0)):
                        if read:
                            read[int(rng.integers(0, len(read)))] = str(
                                rng.choice(list("ACGTNacgt")))
                    f.write(f"@r{ri}\n{''.join(read)}\n+\n{'I'*len(read)}\n")
            subprocess.run(
                [os.path.join(REFBIN, "ed-vaf-counter"), "-p", f"{d}/p.txt",
                 "-o", f"{d}/ref.vaf", "-e", str(max_e), f"{d}/r.fq"],
                capture_output=True, check=True)
            with contextlib.redirect_stdout(io.StringIO()):
                rc = get_tool("ed-vaf-counter")(
                    ["-p", f"{d}/p.txt", "-o", f"{d}/our.vaf",
                     "-e", str(max_e), f"{d}/r.fq"])
            assert not rc
            if open(f"{d}/our.vaf").read() != open(f"{d}/ref.vaf").read():
                fails += 1
                sub = subprocess.run(["diff", f"{d}/our.vaf", f"{d}/ref.vaf"],
                                     capture_output=True)
                print(f"[FAIL] edvaf round {t} -e{max_e} ks={sorted(set(int(x) for x in ks))}\n"
                      + sub.stdout.decode()[:500])
                os.system(f"cp {d}/p.txt /tmp/fuzz_edvaf_fail_{t}.pat; "
                          f"cp {d}/r.fq /tmp/fuzz_edvaf_fail_{t}.fq")
            else:
                print(f"[ok] edvaf round {t} -e{max_e} "
                      f"ks={sorted(set(int(x) for x in ks))}")
    print(f"edvaf done: {rounds - fails}/{rounds} clean")
    return fails


def _gen_sam_case(rng, d):
    """Write a random pattern file ({d}/p.txt) and adversarial SAM
    ({d}/a.sam): CIGARs with S/I/D/N/H clips, lowercase bases,
    unmapped/dup/qcfail flags, off-reference positions."""
    glen = int(rng.integers(2000, 8000))
    g = "".join(rng.choice(list("ACGT"), size=glen))
    k = 21
    with open(f"{d}/s.bed", "w") as f:
        for si in range(int(rng.integers(10, 40))):
            pos = int(rng.integers(50, glen - 50))
            ref = g[pos]
            alt = rng.choice([c for c in "ACGT" if c != ref])
            f.write(f"chr1\t{pos}\t{pos+1}\trs{si}\t{ref}\t{alt}\n")
    with open(f"{d}/g.fa", "w") as f:
        f.write(f">chr1\n{g}\n")
    args = [f"-k{k}", "-b", f"{d}/s.bed", "-f", f"{d}/g.fa",
            "-o", f"{d}/p.txt"]
    subprocess.run([os.path.join(REFBIN, "snp-pattern-gen")] + args,
                   capture_output=True, check=True)
    # random SAM
    with open(f"{d}/a.sam", "w") as f:
        f.write("@HD\tVN:1.6\tSO:unknown\n")
        f.write(f"@SQ\tSN:chr1\tLN:{glen}\n")
        for ri in range(int(rng.integers(100, 500))):
            pos = int(rng.integers(0, glen - 200))
            flag = int(rng.choice([0, 16, 4, 256, 1024, 512],
                                  p=[.5, .3, .05, .05, .05, .05]))
            # build a random VALID CIGAR: optional leading/trailing
            # soft/hard clips, middle ops M/I/D/N only (htslib
            # rejects mid-CIGAR clips and the reference then stops
            # reading at the first invalid record)
            cig = []
            if rng.random() < 0.3:
                if rng.random() < 0.5:
                    cig.append(f"{int(rng.integers(1, 20))}H")
                cig.append(f"{int(rng.integers(1, 20))}S")
            cig.append(f"{int(rng.integers(20, 60))}M")
            for _ in range(int(rng.integers(0, 3))):
                op = rng.choice(list("IDN"), p=[.4, .4, .2])
                cig.append(f"{int(rng.integers(1, 30))}{op}")
                cig.append(f"{int(rng.integers(10, 50))}M")
            tail = []
            if rng.random() < 0.3:
                tail.append(f"{int(rng.integers(1, 20))}S")
                if rng.random() < 0.5:
                    tail.append(f"{int(rng.integers(1, 20))}H")
            cig += tail
            rp = pos + sum(int(p[:-1]) for p in cig if p[-1] in "MDN")
            if rp > glen:
                continue
            seq_chars = []
            # sequence roughly matching the reference at M ops
            cur = pos
            for piece in cig:
                ln, op = int(piece[:-1]), piece[-1]
                if op == "M":
                    frag = list(g[cur:cur + ln])
                    for _ in range(rng.poisson(0.5)):
                        if frag:
                            frag[int(rng.integers(0, len(frag)))] = str(
                                rng.choice(list("ACGTN")))
                    seq_chars += frag
                    cur += ln
                elif op in "IS":
                    seq_chars += list(rng.choice(list("ACGT"), size=ln))
                elif op in "DN":
                    cur += ln
            seq = "".join(seq_chars) or "*"
            if rng.random() < 0.1:
                seq = seq.lower()
            # NOTE: '*' SEQ on mapped reads is deliberately NOT
            # fuzzed: the reference reads stale bam1_t buffer
            # memory past l_qseq=0 there (bam_seqi into the
            # reused record buffer), so its counts on such
            # records are undefined; we skip them (see
            # io/bam.py SamTextReader and the CIGAR-walk bound
            # check in tools/bam_vaf_counter.py).
            if flag & 4:
                cigar_s = "*"
            else:
                cigar_s = "".join(cig)
            f.write(f"r{ri}\t{flag}\tchr1\t{pos+1}\t60\t{cigar_s}\t*\t0\t0\t{seq}\t*\n")


def _ensure_sam2cram(path) -> bool:
    if os.path.exists(path):
        return True
    if not os.path.exists("/tmp/htslib_build/libhts.a"):
        return False
    r = subprocess.run(
        ["gcc", "-O2", "-o", path,
         os.path.join(REPO, "scripts", "sam2cram.c"),
         "-I/tmp/htslib_build", "/tmp/htslib_build/libhts.a",
         "-lz", "-lpthread", "-lm"],
        capture_output=True,
    )
    return r.returncode == 0


def fuzz_sam(rounds=10, seed=0, bam=False):
    """Randomized alignment parity for bam-vaf-counter.

    bam=False: SAM text through both implementations (reference htslib
    text parser vs io/bam.py SamTextReader).
    bam=True: the SAM converted to real BGZF BAM (io/bamwrite.py), run
    3-way — reference binary, our native C++ sequential scanner
    (io/native/bam_count.cpp), and our pure-Python BamReader
    (KMER_TPU_NO_NATIVE=1) — all byte-identical."""
    rng = np.random.default_rng(seed)
    import contextlib
    from kmer_tpu.tools import get_tool

    fails = 0
    mode = "bam" if bam else "sam"
    for t in range(rounds):
        with tempfile.TemporaryDirectory() as d:
            _gen_sam_case(rng, d)
            aln = f"{d}/a.sam"
            indexed = False
            if bam:
                from kmer_tpu.io.bamwrite import (sam_to_bam, write_bai,
                                                  write_csi)

                aln = f"{d}/a.bam"
                # half the rounds: coordinate-sorted + index, so the
                # indexed iteration path is fuzzed too; the index
                # alternates .bai / .csi (both implementations try
                # .csi first, hts.c:4745-4760) with the .csi geometry
                # itself randomized around the default (14, 5)
                indexed = bool(rng.integers(0, 2))
                sam_to_bam(f"{d}/a.sam", aln, sort=indexed)
                if indexed:
                    if rng.integers(0, 2):
                        write_bai(aln, aln + ".bai")
                    else:
                        write_csi(aln, aln + ".csi",
                                  min_shift=int(rng.integers(12, 16)),
                                  depth=int(rng.integers(4, 7)))
            subprocess.run(
                [os.path.join(REFBIN, "bam-vaf-counter"), "-p", f"{d}/p.txt",
                 "-o", f"{d}/ref.vaf", aln],
                capture_output=True, check=True)
            with contextlib.redirect_stdout(io.StringIO()):
                rc = get_tool("bam-vaf-counter")(
                    ["-p", f"{d}/p.txt", "-o", f"{d}/our.vaf", aln])
            assert not rc
            outs = [f"{d}/our.vaf"]
            if bam:
                os.environ["KMER_TPU_NO_NATIVE"] = "1"
                try:
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = get_tool("bam-vaf-counter")(
                            ["-p", f"{d}/p.txt", "-o", f"{d}/our_py.vaf", aln])
                    assert not rc
                finally:
                    del os.environ["KMER_TPU_NO_NATIVE"]
                outs.append(f"{d}/our_py.vaf")
                # CRAM leg: BAM -> CRAM via htslib, then reference vs
                # our CramReader (io/cram.py), both sequential (no
                # .crai) so their outputs are directly comparable —
                # stresses feature decode over random S/I/D/N CIGARs,
                # substitutions, N bases, and unmapped verbatim reads
                conv = os.path.join(REFBIN, "sam2cram")
                if _ensure_sam2cram(conv):
                    cram = f"{d}/a.cram"
                    # half the rounds also write a .crai: both sides
                    # then take the indexed multi-count path
                    crai = indexed and bool(rng.integers(0, 2))
                    subprocess.run(
                        [conv, aln, f"{d}/g.fa", cram]
                        + (["index"] if crai else []),
                        capture_output=True, check=True)
                    subprocess.run(
                        [os.path.join(REFBIN, "bam-vaf-counter"),
                         "-p", f"{d}/p.txt", "-o", f"{d}/refc.vaf", cram],
                        capture_output=True, check=True)
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = get_tool("bam-vaf-counter")(
                            ["-p", f"{d}/p.txt", "-o", f"{d}/ourc.vaf",
                             cram])
                    assert not rc
                    if open(f"{d}/ourc.vaf").read() != open(
                            f"{d}/refc.vaf").read():
                        fails += 1
                        print(f"[FAIL] cram round {t}")
                        os.system(f"cp {d}/a.sam /tmp/fuzz_cram_fail_{t}.sam")
                        continue
            want = open(f"{d}/ref.vaf").read()
            bad = [o for o in outs if open(o).read() != want]
            if bad:
                fails += 1
                sub = subprocess.run(["diff", bad[0], f"{d}/ref.vaf"],
                                     capture_output=True)
                print(f"[FAIL] {mode} round {t} ({bad})\n"
                      + sub.stdout.decode()[:400])
                os.system(f"cp {d}/a.sam /tmp/fuzz_{mode}_fail_{t}.sam; "
                          f"cp {d}/p.txt /tmp/fuzz_{mode}_fail_{t}.pat")
            else:
                print(f"[ok] {mode} round {t}")
    print(f"{mode} done: {rounds - fails}/{rounds} clean")
    return fails


def fuzz_vcf(rounds=10, seed=0):
    """Randomized VCF parity for vcf-vaf-counter: exercises the
    GT/AD/DP depth branches (AD present/missing/partial, DP-with-GT
    estimation, het split, missing genotypes, multi-allelic and indel
    records, duplicate positions with assign-not-accumulate semantics,
    min-depth filter) against the htslib-based reference."""
    rng = np.random.default_rng(seed)
    import contextlib
    from kmer_tpu.tools import get_tool

    fails = 0
    for t in range(rounds):
        with tempfile.TemporaryDirectory() as d:
            _gen_sam_case(rng, d)  # builds {d}/p.txt patterns on chr1
            pats = []
            with open(f"{d}/p.txt") as f:
                for line in f:
                    c = line.split("\t")
                    # 8-col pattern row: chr start end rsid ref alt kmers
                    pats.append((int(c[1]), c[4], c[5]))
            glen = 8000
            n_samples = int(rng.integers(1, 4))
            with open(f"{d}/a.vcf", "w") as f:
                f.write("##fileformat=VCFv4.2\n")
                f.write(f"##contig=<ID=chr1,length={glen}>\n")
                f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="G">\n')
                f.write('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="A">\n')
                f.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="D">\n')
                samples = "\t".join(f"S{i+1}" for i in range(n_samples))
                f.write(
                    f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{samples}\n"
                )
                rows = []
                for ri in range(int(rng.integers(20, 120))):
                    if pats and rng.random() < 0.7:
                        pos, ref, alt = pats[int(rng.integers(0, len(pats)))]
                    else:
                        pos = int(rng.integers(0, glen))
                        ref = str(rng.choice(list("ACGT")))
                        alt = str(rng.choice([c for c in "ACGT" if c != ref]))
                    r = rng.random()
                    if r < 0.1:
                        alt = alt + "," + str(rng.choice(list("ACGT")))
                    elif r < 0.18:
                        ref = ref + "C"  # indel-like
                    fmt_kind = int(rng.integers(0, 4))
                    fmt = ["GT", "GT:AD", "GT:DP", "GT:AD:DP"][fmt_kind]
                    cols = []
                    for _s in range(n_samples):
                        gt = str(rng.choice(
                            ["0/0", "0/1", "1/1", "1|0", "./.", ".", "0", "1/2"],
                            p=[.2, .3, .2, .1, .08, .04, .04, .04]))
                        ad_r, ad_a = int(rng.integers(0, 40)), int(rng.integers(0, 40))
                        dp = int(rng.integers(0, 80))
                        if fmt_kind == 0:
                            cols.append(gt)
                        elif fmt_kind == 1:
                            ad = f"{ad_r},{ad_a}" if rng.random() < 0.8 else "."
                            cols.append(f"{gt}:{ad}")
                        elif fmt_kind == 2:
                            dps = str(dp) if rng.random() < 0.8 else "."
                            cols.append(f"{gt}:{dps}")
                        else:
                            ad = f"{ad_r},{ad_a}" if rng.random() < 0.7 else "."
                            dps = str(dp) if rng.random() < 0.8 else "."
                            cols.append(f"{gt}:{ad}:{dps}")
                    sample = "\t".join(cols)
                    rows.append((pos, f"chr1\t{pos+1}\trs\t{ref}\t{alt}\t50\tPASS\t.\t{fmt}\t{sample}\n"))
                rows.sort(key=lambda x: x[0])  # htslib wants sorted-ish
                for _, line in rows:
                    f.write(line)
            min_d = int(rng.choice([1, 1, 5, 10]))
            s_idx = int(rng.integers(0, n_samples + 1))  # may exceed
            extra = ["-d", str(min_d), "-s", str(s_idx)]
            subprocess.run(
                [os.path.join(REFBIN, "vcf-vaf-counter"), "-p", f"{d}/p.txt",
                 "-v", f"{d}/a.vcf", "-o", f"{d}/ref.vaf"] + extra,
                capture_output=True, check=True)
            with contextlib.redirect_stdout(io.StringIO()):
                rc = get_tool("vcf-vaf-counter")(
                    ["-p", f"{d}/p.txt", "-v", f"{d}/a.vcf",
                     "-o", f"{d}/our.vaf"] + extra)
            assert not rc
            if open(f"{d}/our.vaf").read() != open(f"{d}/ref.vaf").read():
                fails += 1
                sub = subprocess.run(["diff", f"{d}/our.vaf", f"{d}/ref.vaf"],
                                     capture_output=True)
                print(f"[FAIL] vcf round {t} -d{min_d} -s{s_idx} "
                      f"ns={n_samples}\n" + sub.stdout.decode()[:500])
                os.system(f"cp {d}/a.vcf /tmp/fuzz_vcf_fail_{t}.vcf; "
                          f"cp {d}/p.txt /tmp/fuzz_vcf_fail_{t}.pat")
            else:
                print(f"[ok] vcf round {t} -d{min_d} -s{s_idx} ns={n_samples}")
    print(f"vcf done: {rounds - fails}/{rounds} clean")
    return fails




def fuzz_cram31(rounds=10, seed=0):
    """Randomized CRAM 3.1 codec parity: random payload shapes through
    the C encoders (tests/refbin/rans_nx16_fixture — htscodecs itself)
    at random transform flag combinations, decoded by
    kmer_tpu/io/cram31.py + cram_arith.py, byte-compared to the input.
    Complements the deterministic sweep in tests/test_cram31_codecs.py
    with adversarial payloads (tiny sizes, single-symbol, high-entropy,
    run-heavy, name-shaped)."""
    import random
    import subprocess
    import tempfile

    from kmer_tpu.io.cram31 import rans_nx16_decode, tok3_decode_names
    from kmer_tpu.io.cram_arith import arith_decode, fqz_decode
    from tests import oracles

    try:
        enc = oracles.ensure("rans_nx16_fixture")
    except oracles.OracleBuildError as e:
        print(f"[skip] {e}")
        return 0
    rans_orders = [0, 1, 4, 5, 8, 9, 12, 13, 32, 64, 65, 128, 129, 132,
                   133, 136, 140, 192, 193, 196, 200]
    arith_orders = [0, 1, 8, 9, 32, 64, 65, 128, 129, 136, 140, 192,
                    193, 200]
    fails = 0
    for t in range(rounds):
        rng = random.Random(seed + t)
        n = rng.choice([1, 2, 5, 63, 64, 65, 1000, 4096, 65537])
        kind = rng.choice(["const", "acgt", "runs", "bytes", "biased"])
        if kind == "const":
            payload = bytes([rng.randrange(256)]) * n
        elif kind == "acgt":
            payload = bytes(rng.choice(b"ACGT") for _ in range(n))
        elif kind == "runs":
            out = bytearray()
            while len(out) < n:
                out += bytes([rng.randrange(4)]) * rng.randint(1, 30)
            payload = bytes(out[:n])
        elif kind == "biased":
            payload = bytes(rng.randrange(256) if rng.random() < 0.2
                            else 65 for _ in range(n))
        else:
            payload = bytes(rng.randrange(256) for _ in range(n))
        with tempfile.TemporaryDirectory() as td:
            src_f = f"{td}/in.bin"
            out_f = f"{td}/out.bin"
            with open(src_f, "wb") as f:
                f.write(payload)
            for mode, orders, dec in (
                ("rans", rans_orders, rans_nx16_decode),
                ("arith", arith_orders, arith_decode),
            ):
                for order in rng.sample(orders, 6):
                    r = subprocess.run([enc, mode, str(order), src_f,
                                        out_f], capture_output=True)
                    if r.returncode:
                        continue  # encoder declines some combos/sizes
                    with open(out_f, "rb") as f:
                        blob = f.read()
                    try:
                        got = dec(blob, len(payload))
                    except Exception as e:
                        print(f"[FAIL] {mode} o={order} {kind} n={n}: "
                              f"{type(e).__name__}: {e}")
                        fails += 1
                        continue
                    if got != payload:
                        print(f"[FAIL] {mode} o={order} {kind} n={n}: "
                              f"mismatch")
                        fails += 1
            # name-shaped payloads through tok3; qual-shaped through fqz
            names = b"".join(
                b"%s%d:%d/%d\n" % (rng.choice([b"r", b"SRR9.", b"M0:"]),
                                   rng.randrange(9999), rng.randrange(99),
                                   1 + i % 2)
                for i in range(rng.randint(1, 400)))
            with open(src_f, "wb") as f:
                f.write(names)
            r = subprocess.run([enc, "tok3", str(rng.choice([1, 3, 7, 9])),
                                src_f, out_f], capture_output=True)
            if r.returncode == 0:
                with open(out_f, "rb") as f:
                    blob = f.read()
                try:
                    if tok3_decode_names(blob, None) != \
                            names.replace(b"\n", b"\0"):
                        print(f"[FAIL] tok3 round {t}: mismatch")
                        fails += 1
                except Exception as e:
                    print(f"[FAIL] tok3 round {t}: {type(e).__name__}: {e}")
                    fails += 1
            quals = b"".join(
                bytes(33 + min(40, max(0, int(rng.gauss(30, 6))))
                      for _ in range(rng.choice([50, 100, 151])))
                + b"\n" for _ in range(rng.randint(1, 300)))
            with open(src_f, "wb") as f:
                f.write(quals)
            mode = rng.choice(["fqz", "fqz3"])
            r = subprocess.run([enc, mode, str(rng.randrange(7)), src_f,
                                out_f], capture_output=True)
            if r.returncode == 0:
                with open(out_f, "rb") as f:
                    blob = f.read()
                raw = quals.replace(b"\n", b"")
                try:
                    if fqz_decode(blob, len(raw)) != raw:
                        print(f"[FAIL] {mode} round {t}: mismatch")
                        fails += 1
                except Exception as e:
                    print(f"[FAIL] {mode} round {t}: "
                          f"{type(e).__name__}: {e}")
                    fails += 1
        if not fails:
            print(f"[ok] cram31 round {t} ({kind} n={n})")
    print(f"cram31 done: {rounds - fails}/{rounds} clean")
    return fails


if __name__ == "__main__":
    if "--cram31" in sys.argv:
        sys.argv.remove("--cram31")
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_cram31(rounds, seed) else 0)
    if "--vcf" in sys.argv:
        sys.argv.remove("--vcf")
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_vcf(rounds, seed) else 0)
    if "--edvaf" in sys.argv:
        sys.argv.remove("--edvaf")
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_edvaf(rounds, seed) else 0)
    if "--raw" in sys.argv:
        sys.argv.remove("--raw")
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_raw(rounds, seed) else 0)
    if "--pipeline" in sys.argv:
        sys.argv.remove("--pipeline")
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_pipeline(rounds, seed) else 0)
    if "--sam" in sys.argv or "--bam" in sys.argv:
        bam = "--bam" in sys.argv
        for flag in ("--sam", "--bam"):
            if flag in sys.argv:
                sys.argv.remove(flag)
        rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
        seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
        sys.exit(1 if fuzz_sam(rounds, seed, bam=bam) else 0)
    sys.exit(main())
