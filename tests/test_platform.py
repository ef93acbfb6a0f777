"""Platform-neutral choices, the compile-cache rule, the histogram core
and chip_smoke.py's numpy oracle — all on the CPU backend; one `gpu`
check runs only where a GPU backend exists."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from ref_np import hash64_np, rolling_kmers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys_with_sentinels(rng, n, n_pad, n_distinct):
    keys = hash64_np(rng.integers(0, n_distinct, n - n_pad), (1 << 62) - 1)
    hi = np.full(n, 0xFFFFFFFF, np.uint32)
    lo = np.full(n, 0xFFFFFFFF, np.uint32)
    hi[: keys.size] = (keys >> np.uint64(32)).astype(np.uint32)
    lo[: keys.size] = keys.astype(np.uint32)
    return keys, hi, lo


@pytest.mark.parametrize("mode", ["unweighted", "weighted", "clamped"])
def test_hist_xla_core_matches_numpy(mode):
    """hist_core (via the jitted _hist_impl) against np.unique: the
    unweighted and weighted paths, and a bins_cfg-style clamp
    (max_count 255, min_keep 2)."""
    from kmer_tpu.table import compactor

    rng = np.random.default_rng(len(mode))
    n = 1 << 16
    keys, hi, lo = _keys_with_sentinels(rng, n, 999, 5000)
    w = rng.integers(1, 5, n).astype(np.uint32)
    w[keys.size:] = 0
    uniq, inv = np.unique(keys, return_inverse=True)
    if mode == "weighted":
        cnt = np.bincount(inv, weights=w[: keys.size]).astype(np.int64)
    else:
        cnt = np.bincount(inv)
    mx, mk = (255, 2) if mode == "clamped" else (None, 1)
    c = cnt if mx is None else np.minimum(cnt, mx)
    keep = c >= mk
    want = np.bincount(np.minimum(c[keep], 255), minlength=256)
    want[0] = 0
    h, nd = compactor._hist_impl(
        jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(w) if mode == "weighted" else jnp.asarray(hi),
        256, mx, mk, mode == "weighted")
    assert np.array_equal(np.asarray(h), want)
    assert int(nd) == int(keep.sum())


def test_histogram_spill_matches_bincount():
    """Masked lanes go to the spill bins and are never counted; bins past
    the end clamp into the last one."""
    from kmer_tpu.kernels import segops

    rng = np.random.default_rng(1)
    n = 3 * segops.HIST_SPILL + 17
    b = rng.integers(0, 300, n).astype(np.int32)
    m = rng.random(n) < 0.3
    got = segops.histogram(jnp.asarray(b), jnp.asarray(m), 256)
    assert np.array_equal(np.asarray(got),
                          np.bincount(np.minimum(b[m], 255), minlength=256))


@pytest.mark.parametrize("gate", ["stream_sort", "packed", "upload", "mesh"])
def test_gate_defaults_and_overrides(gate, monkeypatch):
    """Each platform-neutral default holds with no override, and its
    KMER_TPU_* variable overrides it both ways."""
    from kmer_tpu.io import native
    from kmer_tpu.pipeline import counter
    from kmer_tpu.table import compactor

    if gate == "stream_sort":
        var, fn = "KMER_TPU_STREAM_SORT", compactor.stream_sorted_default
        default = compactor.STREAM_SORTED_DEFAULT
    elif gate == "packed":
        var = "KMER_TPU_PACKED"
        fn = lambda: counter._use_packed_ingest(["x.fq"])  # noqa: E731
        default = counter.PACKED_INGEST_DEFAULT and native.available()
        monkeypatch.setattr(native, "available", lambda: True)
    elif gate == "upload":
        monkeypatch.delenv("KMER_TPU_UPLOAD_THREADS", raising=False)
        assert counter._upload_threads() == counter.UPLOAD_THREADS
        monkeypatch.setenv("KMER_TPU_UPLOAD_THREADS", "5")
        assert counter._upload_threads() == 5
        monkeypatch.setenv("KMER_TPU_UPLOAD_THREADS", "junk")
        assert counter._upload_threads() == counter.UPLOAD_THREADS
        return
    else:
        # the suite runs 8 virtual CPU devices: more than one device
        # engages the mesh unless KMER_TPU_FORCE_MESH says otherwise
        var, fn, default = "KMER_TPU_FORCE_MESH", counter.use_mesh, True
    monkeypatch.delenv(var, raising=False)
    if gate != "packed":
        assert fn() == default
    for val, want in (("1", True), ("on", True), ("0", False),
                      ("off", False)):
        monkeypatch.setenv(var, val)
        assert fn() == want, (var, val)
    if gate == "packed":
        monkeypatch.setenv(var, "1")
        assert counter._use_packed_ingest(["-"]) is False  # stdin: never


def _cache_dir(env):
    code = ("import sys; sys.path.insert(0, %r); import kmer_tpu, os; "
            "print(os.environ['JAX_COMPILATION_CACHE_DIR'])" % REPO)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def test_compile_cache_defaults_inside_checkout():
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    got = _cache_dir(env)
    assert os.path.dirname(got) == os.path.join(REPO, ".jax_cache")
    assert os.path.basename(got).startswith("cpu_")
    env["JAX_PLATFORMS"] = "cuda"
    assert _cache_dir(env) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_wins(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert _cache_dir(env) == str(tmp_path / "c")


@pytest.mark.parametrize("k", [15, 31, 32])
def test_chip_smoke_oracle_matches_rolling_kmers(k):
    """chip_smoke.py's vectorised oracle against the scalar rolling loop
    of tests/ref_np.py, on clean reads (canonical_windows) and on a
    flat buffer with N bases and separators (flat_keys)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (20, 60)).astype(np.uint8)
    got = cs.canonical_windows(codes, k)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for r in range(codes.shape[0]):
        want = [y for _, y in rolling_kmers(acgt[codes[r]].tobytes(), k,
                                            do_hash=True)]
        assert got[r].tolist() == want
    flat = rng.choice(np.frombuffer(b"ACGTNacg\x00", np.uint8), size=3000,
                      p=[.23, .23, .23, .23, .02, .02, .02, .01, .01])
    keys, valid = cs.flat_keys(flat, k)
    want = rolling_kmers(flat.tobytes(), k, do_hash=True)
    assert np.flatnonzero(valid).tolist() == [i for i, _ in want]
    assert keys[valid].tolist() == [y for _, y in want]


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, chip_smoke.py fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_device_extract_and_hist_match_cpu(gpu, tmp_path):
    """On a GPU host: the extraction step and the histogram core give
    the same bytes on the GPU as on the CPU backend."""
    code = r"""
import sys, numpy as np
sys.path.insert(0, %r)
import jax.numpy as jnp
from kmer_tpu.pipeline.counter import _extract_step
from kmer_tpu.table.compactor import _hist_impl
rng = np.random.default_rng(0)
buf = rng.choice(np.frombuffer(b"ACGTN\x00", np.uint8), size=1 << 20,
                 p=[.24, .24, .24, .24, .02, .02])
out = []
for k in (15, 21, 31, 32):
    hi, lo, nk = _extract_step(jnp.asarray(buf), k)
    h, nd = _hist_impl(hi, lo, hi, 256, 255, 1, False)
    out += [np.asarray(hi), np.asarray(lo), np.asarray(h), np.int64(nd)]
np.savez(sys.argv[1], *out)
""" % REPO
    res = {}
    for plat in ("gpu", "cpu"):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        if plat == "cpu":
            env["JAX_PLATFORMS"] = "cpu"
        f = str(tmp_path / f"{plat}.npz")
        subprocess.run([sys.executable, "-c", code, f], env=env, check=True,
                       timeout=600)
        res[plat] = np.load(f)
    for name in res["cpu"].files:
        assert np.array_equal(res["gpu"][name], res["cpu"][name]), name


@pytest.mark.parametrize("shape", ["well_formed", "ragged", "truncated"])
def test_read_vaf_file(shape, tmp_path, capsys):
    """read_vaf_file keeps load_vaf_file's sscanf semantics: short rows
    skipped, extra fields ignored, non-numeric rows skipped, and rows
    past max_snps dropped with a warning."""
    from kmer_tpu.io.formats import read_vaf_file

    rows = ["chr1\t100\trs1\tA\tC\t3\t1\t4\t0.2500",
            "chr2\t200\trs2\tG\tT\t0\t0\t0\t0.0000",
            "chrX\t300\trs3\tT\tA\t5\t5\t10\t0.5000"]
    if shape == "ragged":
        rows[1] += "\textra"
        rows.insert(1, "chr9\t1\trs9\tA\tC\t1")          # too short
        rows.insert(1, "chr9\tx\trs9\tA\tC\t1\t1\t2\t0.5")  # bad number
    p = tmp_path / "s1.vaf"
    p.write_text("# Average depth: 4.67\nCHR\tPOS\tRSID\tREF\tALT\t"
                 "REF_COUNT\tALT_COUNT\tTOTAL_COUNT\tVAF\n"
                 + "\n".join(rows) + "\n")
    n = 2 if shape == "truncated" else 3
    s = read_vaf_file(str(p), max_snps=n)
    assert s.name == "s1"
    assert s.snps == [("chr1", 100, "rs1"), ("chr2", 200, "rs2"),
                      ("chrX", 300, "rs3")][:n]
    assert s.depth == [4, 0, 10][:n]
    assert s.vaf == [0.25, 0.0, 0.5][:n]
    warned = "too many SNPs" in capsys.readouterr().err
    assert warned == (shape == "truncated")
