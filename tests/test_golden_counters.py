"""Golden parity tests: our CLI tools vs the compiled C reference tools
on the committed fixtures (the reference's own implicit test methodology
— run two counters, diff histograms; see SURVEY.md §4)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFBIN = os.path.join(REPO, "tests", "refbin")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
READS = os.path.join(FIXTURES, "reads_small.fq.gz")
GENOME = os.path.join(FIXTURES, "genome_small.fa.gz")

@pytest.fixture(scope="session")
def refbin():
    """Build via the one canonical recipe table (tests/oracles.py)."""
    from tests import oracles

    try:
        return oracles.ensure_all(
            ["kc-c1", "kc-c2", "kc-c3", "kc-c4", "yak-count"])
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))


def run_ref(refbin, tool, args):
    r = subprocess.run(
        [os.path.join(refbin, tool)] + args, capture_output=True, check=True
    )
    return r.stdout.decode()


def run_ours(tool, args, capsys):
    from kmer_tpu.tools import get_tool

    rc = get_tool(tool)(args)
    assert not rc
    return capsys.readouterr().out


@pytest.fixture(scope="session")
def refbin_cpp():
    from tests import oracles

    try:
        return oracles.ensure_all(["kc-cpp1", "kc-cpp2"])
    except oracles.OracleBuildError as e:
        pytest.skip(str(e))


@pytest.mark.parametrize("tool", ["kc-cpp1", "kc-cpp2"])
def test_cpp_counter_parity(refbin_cpp, capsys, tool):
    import gzip
    import tempfile

    # the C++ reference tools have a naive line-based reader that only
    # understands uncompressed FASTA (kc-cpp1.cpp:29-43)
    with gzip.open(GENOME, "rb") as f:
        raw = f.read()
    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as tf:
        tf.write(raw)
        path = tf.name
    try:
        want = run_ref(refbin_cpp, tool, ["-k31", path])
        got = run_ours(tool, ["-k31", path], capsys)
        assert got == want
    finally:
        os.unlink(path)


_DIRTY = (
    b">r1 desc\nacgtACGTnNxRy-acgtACGTacgtACGTacgtACGT\nACGTacgt\n"
    b">empty\n"
    b">r2\n" + b"CGTAcgtaNNNNcgtaCGTAcgtaCGTAcgtaCGTA" * 3 + b"\n"
    b"@fastq_as_fasta\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n"
    b"+\nIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII"  # no trailing newline
)


@pytest.mark.parametrize("tool", ["kc-cpp1", "kc-cpp2"])
@pytest.mark.parametrize("k", [5, 31])
def test_cpp_counter_dirty_input_parity(refbin_cpp, capsys, tool, k):
    """Raw-string semantics on non-clean input: lowercase-as-distinct
    keys, junk characters in keys, FASTQ-as-line-FASTA, missing final
    newline — byte-identical to the C++ originals (kc-cpp1.cpp:11-43)."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".fa", delete=False) as tf:
        tf.write(_DIRTY)
        path = tf.name
    try:
        want = run_ref(refbin_cpp, tool, [f"-k{k}", path])
        got = run_ours(tool, [f"-k{k}", path], capsys)
        assert got == want
    finally:
        os.unlink(path)


def test_py1_counter_dirty_input_parity(capsys):
    """kc-py1 quirks on non-clean stdin: only the FINAL record is
    uppercased, the last char of the final line is dropped when the
    newline is missing (kc-py1.py:27-34)."""
    import io

    r = subprocess.run(
        [sys.executable, "/root/reference/kc-py1.py"],
        input=_DIRTY, capture_output=True, check=True,
    )
    want = r.stdout.decode()
    from kmer_tpu.tools import get_tool

    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(_DIRTY))
    try:
        rc = get_tool("kc-py1")([])
    finally:
        sys.stdin = old
    assert not rc
    assert capsys.readouterr().out == want


def test_py1_counter_parity(capsys):
    """kc-py1: fixed k=31, FASTA from stdin (kc-py1.py:45)."""
    import gzip

    with gzip.open(GENOME, "rb") as f:
        raw = f.read()
    r = subprocess.run(
        [sys.executable, "/root/reference/kc-py1.py"],
        input=raw, capture_output=True, check=True,
    )
    want = r.stdout.decode()

    import io

    from kmer_tpu.tools import get_tool

    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(raw))
    try:
        rc = get_tool("kc-py1")([])
    finally:
        sys.stdin = old
    assert not rc
    assert capsys.readouterr().out == want


# every golden case runs twice: single-device engine and the 8-virtual-
# device mesh engine through the same CLI entry point (the reference's
# parallel runtime is on by default, kc-c4.c:181-191 — ours must be
# reachable and bit-identical from the product surface too)
@pytest.fixture(params=["single", "mesh"])
def engine_mode(request, monkeypatch):
    monkeypatch.setenv("KMER_TPU_FORCE_MESH",
                       "1" if request.param == "mesh" else "0")
    return request.param


@pytest.mark.parametrize(
    "tool,args",
    [
        ("kc-c1", ["-k21", READS]),
        ("kc-c1", ["-k31", GENOME]),
        # k=32: the reference's mask expression shifts by 64 (x86 UB,
        # computes mod 64 -> mask 0, all keys collapse to 0); we
        # reproduce the x86-64 behavior bit-for-bit
        ("kc-c1", ["-k32", READS]),
        ("kc-c4", ["-k32", READS]),
        ("kc-c2", ["-k31", READS]),
        ("kc-c3", ["-k31", "-b1000000", READS]),
        ("kc-c4", ["-k31", "-t4", READS]),
        ("yak-count", ["-k31", READS]),
        ("yak-count", ["-k31", "-b22", READS]),
        ("yak-count", ["-k21", "-b20", "-H3", READS]),
        # two-file mode: pass 1 bloom-gates fn1, pass 2 recounts fn2 —
        # exercises the bloom + hash-table engine (the single-file case
        # takes the sort-engine fast path)
        ("yak-count", [
            "-k31", "-b16",
            os.path.join(FIXTURES, "sampleA1.fq.gz"),
            os.path.join(FIXTURES, "sampleB.fq.gz"),
        ]),
    ],
)
def test_counter_parity(refbin, capsys, engine_mode, tool, args):
    want = run_ref(refbin, tool, args)
    got = run_ours(tool, args, capsys)
    assert got == want


def run_ref_with_err(refbin, tool, args):
    r = subprocess.run(
        [os.path.join(refbin, tool)] + args, capture_output=True, check=True
    )
    return r.stdout.decode(), r.stderr.decode()


def run_ours_with_err(tool, args, capsys):
    from kmer_tpu.tools import get_tool

    capsys.readouterr()  # drop anything buffered before the call
    rc = get_tool(tool)(args)
    assert not rc
    cap = capsys.readouterr()
    # our stderr may carry harness noise (e.g. jax logging); the
    # reference's progress/summary lines all start with "[M" — the
    # byte-identity claim covers exactly those lines, in order
    err = "".join(l + "\n" for l in cap.err.splitlines()
                  if l.startswith("[M"))
    return cap.out, err


@pytest.mark.parametrize(
    "args",
    [
        # multi-batch single file, bloom on: pass-1 lines carry the
        # bloom-FP-inclusive running totals per reference batch
        # (yak-count.c:427), pass-2 lines repeat the pre-shrink total
        # — PARITY divergence 8 closed (admission simulation rides the
        # sort engine's extracted planes, tools/yak_count.py)
        ["-k21", "-b19", "-K30000", READS],
        # multi-batch single file, no bloom: one pass, running distinct
        ["-k21", "-K25000", READS],
        # one batch (default -K), bloom on
        ["-k31", "-b22", READS],
        # two-file mode: live per-batch logging through both passes
        ["-k21", "-b19", "-K20000", READS,
         os.path.join(FIXTURES, "sampleB.fq.gz")],
    ],
)
def test_yak_stderr_progress_parity(refbin, capsys, monkeypatch, args):
    """stdout AND stderr byte-identical to the reference yak-count —
    the per-batch "[M] processed N sequences; M distinct k-mers" lines
    (batch composition from the reference step-0 rule, totals from the
    sequential-exact bloom + gated-table simulation) and the final
    "[M::main] ... after shrinking" line.  Single-device path: mesh
    batch composition is device-partitioned (PARITY.md div. 8 scope)."""
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", "0")
    want_out, want_err = run_ref_with_err(refbin, "yak-count", args)
    got_out, got_err = run_ours_with_err("yak-count", args, capsys)
    assert got_out == want_out
    assert got_err == want_err


@pytest.mark.parametrize("mesh", ["0", "1"])
def test_yak_two_file_exact_bloom_parity(refbin, capsys, monkeypatch, mesh):
    """Two-file yak with a bloom SMALL enough to really gate (-b19:
    2^9 bits/subtable, the reference's own minimum geometry) on the
    DEFAULT path, single-chip AND 8-device mesh — sequential
    test-and-set semantics (kernels/bloom.insert_sequential) make
    admission byte-identical even when in-batch cross-key collisions
    occur (PARITY.md divergence 10 closed by default;
    KMER_TPU_EXACT_BLOOM=0 opts out).  The env var is deliberately NOT
    set here.  -K65536 splits the ~600 kb fn1 into ~10 stream chunks so
    one mesh step carries a FULL 8-chunk batch: this pins the
    cross-segment ordering claim in dist.sharded.sharded_yak_ingest_fn
    (stable routing sort + source-ordered all_to_all ≡ stream order),
    not just within-chunk order."""
    monkeypatch.setenv("KMER_TPU_FORCE_MESH", mesh)
    monkeypatch.delenv("KMER_TPU_EXACT_BLOOM", raising=False)
    args = ["-k31", "-b19", "-K65536",
            os.path.join(FIXTURES, "sampleA1.fq.gz"),
            os.path.join(FIXTURES, "sampleB.fq.gz")]
    want = run_ref(refbin, "yak-count", args)
    got = run_ours("yak-count", args, capsys)
    assert got == want


def test_long_chromosome_split_parity(tmp_path):
    """A sequence much longer than the block size must split into
    (k-1)-overlap chunks with no window lost or duplicated — checked
    against the reference on all three ingest paths (native ASCII,
    native 2-bit packed, pure Python)."""
    import gzip

    import numpy as np

    ref = os.path.join(REFBIN, "kc-c4")
    if not os.path.exists(ref):
        pytest.skip("reference kc-c4 not built")
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    seq = acgt[rng.choice(5, 300_000, p=[0.24, 0.24, 0.24, 0.24, 0.04])]
    fa = str(tmp_path / "chrom.fa.gz")
    with gzip.open(fa, "wb") as f:
        f.write(b">chr1\n")
        s = seq.tobytes()
        for off in range(0, len(s), 70):
            f.write(s[off : off + 70] + b"\n")
        f.write(b">tiny\nACGTACGTACGTACGTACGTACGTACGTACGT\n")
    want = subprocess.run(
        [ref, "-k31", "-b50000", fa], capture_output=True, check=True
    ).stdout
    from kmer_tpu.tools.kc import main_kc_c4

    for env in ({}, {"KMER_TPU_PACKED": "1"}, {"KMER_TPU_NO_NATIVE": "1"}):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            import contextlib
            import io as _io

            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert not main_kc_c4(["-k31", "-b50000", fa])
            assert buf.getvalue().encode() == want, env
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def test_truncated_gzip_prefix_parity(tmp_path):
    """A truncated .gz input must count its readable prefix exactly like
    the reference (zlib gzread semantics), on both the native and the
    pure-Python reader."""
    ref = os.path.join(REFBIN, "kc-c1")
    if not os.path.exists(ref):
        pytest.skip("reference kc-c1 not built")
    src = os.path.join(FIXTURES, "reads_small.fq.gz")
    trunc = str(tmp_path / "trunc.fq.gz")
    with open(src, "rb") as f:
        data = f.read(2000)
    with open(trunc, "wb") as f:
        f.write(data)
    want = subprocess.run(
        [ref, "-k21", trunc], capture_output=True, check=True
    ).stdout
    import contextlib
    import io as _io

    from kmer_tpu.tools.kc import main_kc_c1

    for env in ({}, {"KMER_TPU_NO_NATIVE": "1"}):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            buf = _io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert not main_kc_c1(["-k21", trunc])
            assert buf.getvalue().encode() == want, env
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def test_malformed_quality_policies(tmp_path):
    """kseq -2 behavior differs per reference tool (stop vs pipeline
    resume with a worker-retirement budget; PARITY.md) — pin one fixed
    input against kc-c1, kc-c3, kc-c4, and yak-count."""
    import numpy as np

    rng = np.random.default_rng(123)
    fq = str(tmp_path / "bad.fq")
    with open(fq, "w") as f:
        for i in range(60):
            L = 60
            s = "".join(rng.choice(list("ACGT"), L))
            if i in (7, 23, 24, 41):  # malformed: quality too short
                f.write(f"@r{i}\n{s}\n+\n{'I' * 10}\n")
            else:
                f.write(f"@r{i}\n{s}\n+\n{'I' * L}\n")
    from kmer_tpu.tools.kc import main_kc_c1, main_kc_c3, main_kc_c4
    from kmer_tpu.tools.yak_count import main as yak_main

    import contextlib
    import io as _io

    cases = [
        ("kc-c1", main_kc_c1, ["-k21", fq]),
        ("kc-c3", main_kc_c3, ["-k21", fq]),
        ("kc-c4", main_kc_c4, ["-k21", fq]),
        ("yak-count", yak_main, ["-k21", "-b14", fq]),
    ]
    for tool, fn, args in cases:
        ref = os.path.join(REFBIN, tool)
        if not os.path.exists(ref):
            pytest.skip(f"reference {tool} not built")
        want = subprocess.run(
            [ref] + args[:-1] + [fq], capture_output=True, check=True
        ).stdout
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert not fn(args)
        assert buf.getvalue().encode() == want, tool


def test_sort_vs_table_yak_engines_identical(tmp_path):
    """The sort-based SortYakEngine (single-chip default) and the
    open-addressing YakEngine must agree exactly on the full two-file
    flow — histogram, tot, and the per-batch (n_seqs, tot) log
    sequence of both passes.  This pins the admission-count identity
    the sort engine is built on (contribution == preset for every
    occurrence under the sequential-exact bloom)."""
    import gzip

    import numpy as np

    from kmer_tpu.pipeline.yak import (SortYakEngine, YakEngine,
                                       yak_count_file)

    rng = np.random.default_rng(23)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.fq.gz")
        with gzip.open(p, "wb") as f:
            for r in range(600):
                s = "".join(rng.choice(list("ACGT"), 120))
                f.write(f"@r{r}\n{s}\n+\n{'I' * 120}\n".encode())
        paths.append(p)

    results = []
    for cls in (SortYakEngine, YakEngine):
        lines = []
        eng = yak_count_file(
            paths[0], paths[1],
            cls(k=21, pre=10, bf_shift=16, bf_n_hash=4, chunk_size=65536,
                log=lambda ns, tot: lines.append((ns, tot))),
        )
        results.append((np.asarray(eng.hist()), eng.tot, lines))
    (h_sort, tot_sort, lines_sort), (h_tab, tot_tab, lines_tab) = results
    assert lines_sort == lines_tab
    assert tot_sort == tot_tab
    assert np.array_equal(h_sort, h_tab)


def test_ktc_cli_full_stderr_byte_identical_warm(refbin):
    """The real ./ktc process surface: stdout AND FULL stderr — no
    [M-line filtering — byte-identical to the reference binary, run
    TWICE in fresh processes, so the second run loads warm
    compile-cache entries: a native XLA log line on a warm load would
    break stderr parity while cold-run diffs (and in-process capsys
    tests) stay clean.  ktc sets the native log level before JAX is
    imported; this pins that it holds."""
    args = ["-k21", "-b19", READS]
    ref = subprocess.run(
        [os.path.join(REFBIN, "yak-count")] + args, capture_output=True,
        check=True,
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for run in ("cold-or-warm", "warm"):
        got = subprocess.run(
            [os.path.join(REPO, "ktc"), "yak-count"] + args,
            capture_output=True, env=env, check=True,
        )
        assert got.stdout == ref.stdout, run
        assert got.stderr == ref.stderr, run
