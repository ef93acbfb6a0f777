#!/usr/bin/env python3
"""chip_smoke.py — drive the tool suite's main path on the GPU and check it.

    python chip_smoke.py                # one GPU: phases 0-3
    python chip_smoke.py --four-cards   # four GPUs: the mesh path only
    python chip_smoke.py --rehearse [--four-cards]
                                        # CPU dry run at a small size

Phases (any failure exits non-zero; nothing is caught and passed over):

  0 device    the first JAX device is a GPU; the card's name and power
              limit, the native reader, the compile cache directory
  1 kernels   every device kernel of the counting path, compiled for the
              card, against an independent numpy reference at the
              engine's 10 M-base block width (k = 15, 21, 31, 32 on reads
              with N bases and separators); the histogram core, the
              scatter histogram and the bitonic merge against numpy
  2 fixtures  every device-using tool on tests/fixtures through ./ktc on
              the GPU, byte for byte against the same command under
              JAX_PLATFORMS=cpu (stdout, stderr, output files)
  3 full size 256 Mbases of seeded 150 bp reads: `kc-c4 -k31`,
              `vaf-counter -k21` (21k SNP patterns) and `yak-count -b30`
              through their CLI entry points, exactly against a numpy
              oracle built from the same seeded read codes

--four-cards runs only the mesh phase: the same three tools on a
four-device mesh and forced onto one device (KMER_TPU_FORCE_MESH=0),
both against the oracle, plus __graft_entry__.dryrun_multichip(4) and a
check that the routing all_to_all spans all four devices.

The parent process never imports JAX: the GPU work runs in one child at
a time (a JAX process reserves most of the card), CPU comparisons in
children pinned with JAX_PLATFORMS=cpu.  The last stdout line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "bench_data", "smoke")
DATA = os.path.join(ROOT, "bench_data")
FIX = os.path.join(ROOT, "tests", "fixtures")
FULL_MBASES = 256
N_SNPS = 21_000
BLOCK_BASES = 10_000_000
SENT64 = 0xFFFFFFFFFFFFFFFF


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)
    say(f"  ok  {what}")


# ---------------------------------------------------------------------------
# numpy oracle: canonical k-mers -> hash64, written independently of the
# package (uint64 arithmetic, the reference's rolling-window definition)

def _np():
    import numpy as np

    return np


def nt4_table():
    np = _np()
    t = np.full(256, 4, np.uint8)
    for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
        t[ord(ch)] = code
        t[ord(ch.lower())] = code
    return t


def hash64_u64(key, k: int):
    """hash64 of kc-c4.c:40-50 with mask (1 << 2k) - 1 (mask 0 at k = 32:
    the x86-64 shift by 64 is a shift by 0)."""
    np = _np()
    mask = np.uint64(0 if k == 32 else (1 << (2 * k)) - 1)
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


def canonical_windows(codes, k: int, do_hash: bool = True):
    """codes: (..., L) uint8 base codes 0..3, no invalid bases.  Returns
    (..., L-k+1) uint64 canonical (optionally hashed) k-mers of every
    window, window j covering codes[..., j:j+k]."""
    np = _np()
    L = codes.shape[-1]
    n_win = L - k + 1
    c = codes.astype(np.uint64)
    fwd = np.zeros(codes.shape[:-1] + (n_win,), np.uint64)
    rev = np.zeros_like(fwd)
    for d in range(k):
        # base at window offset k-1-d lands at bits 2d of fwd; its
        # complement at bits 2(k-1-d) of rev
        sl = c[..., k - 1 - d : k - 1 - d + n_win]
        fwd |= sl << np.uint64(2 * d)
        rev |= (np.uint64(3) - sl) << np.uint64(2 * (k - 1 - d))
    if k == 32:
        # reference semantics: the forward key is masked to 0
        can = np.zeros_like(fwd)
    else:
        can = np.minimum(fwd, rev)
    return hash64_u64(can, k) if do_hash else can


def flat_keys(ascii_buf, k: int):
    """Per-position hashed canonical k-mer over a flat ASCII buffer
    whose invalid bytes reset the window.  Returns (keys, valid)."""
    np = _np()
    codes = nt4_table()[ascii_buf]
    bad = codes > 3
    n = codes.shape[0]
    keys = np.zeros(n, np.uint64)
    valid = np.zeros(n, bool)
    if n >= k:
        c = np.where(bad, 0, codes).astype(np.uint8)
        keys[k - 1:] = canonical_windows(c, k)
        cs = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])
        valid[k - 1:] = (cs[k:] - cs[:-k]) == 0
    return keys, valid


def pattern_keys(patterns_path: str, k: int):
    """Sorted canonical k-mers of the pattern file's ref/alt columns and
    the (row, ref=0/alt=1) that owns each: the first pattern wins a
    k-mer shared by several (vaf-counter.c:198-252)."""
    np = _np()
    t = nt4_table()
    rows = [ln.split("\t") for ln in open(patterns_path).read().splitlines()]
    owner = {}
    for i, r in enumerate(rows):
        for flag, s in ((0, r[6]), (1, r[7])):
            cod = t[np.frombuffer(s.encode(), np.uint8)]
            if len(s) != k or (cod > 3).any():
                continue
            key = int(canonical_windows(cod[None, :], k, do_hash=False)[0, 0])
            owner.setdefault(key, (i, flag))
    pk = np.sort(np.array(list(owner), np.uint64))
    return pk, [owner[x] for x in pk.tolist()], len(rows)


def _oracle_chunk(args):
    """One chunk of reads: all hashed canonical 31-mers, and the hits of
    each pattern 21-mer."""
    np = _np()
    codes, pk = args
    keys = canonical_windows(codes, 21, do_hash=False).reshape(-1)
    idx = np.minimum(np.searchsorted(pk, keys), len(pk) - 1)
    hits = np.bincount(idx[pk[idx] == keys], minlength=len(pk))
    return canonical_windows(codes, 31).reshape(-1), hits


def hist_lines(values, lo: int, hi: int) -> str:
    return "".join(f"{i}\t{int(values[i])}\n" for i in range(lo, hi))


def expected_outputs(mbases: int, patterns_path: str, workers: int) -> dict:
    """The full-size oracle: kc-c4 -k31 and yak-count -b30 histograms
    (text, as the tools print them) and vaf-counter -k21 REF/ALT counts.
    Chunks of reads fan out over `workers` processes."""
    import multiprocessing as mp

    np = _np()
    from kmer_tpu.utils import synth

    t0 = time.time()
    pk, owners, n_rows = pattern_keys(patterns_path, 21)
    parts, hits = [], np.zeros(len(pk), np.int64)
    with mp.get_context("fork").Pool(workers) as pool:
        for keys, h in pool.imap(_oracle_chunk, (
                (c, pk) for c in synth.iter_read_codes(mbases))):
            parts.append(keys)
            hits += h
    _, counts = np.unique(np.concatenate(parts), return_counts=True)
    del parts
    kc4 = hist_lines(np.bincount(np.minimum(counts, 255), minlength=256),
                     1, 256)
    c = np.minimum(counts, 1023)
    yak = hist_lines(np.bincount(c[c >= 2], minlength=1024), 1, 1024)
    vaf = np.zeros((n_rows, 2), np.int64)
    for (i, flag), n in zip(owners, hits.tolist()):
        vaf[i, flag] = n
    return {"kc-c4": kc4, "yak-count": yak, "vaf": vaf,
            "n_distinct": len(counts), "seconds": time.time() - t0}


def child_oracle(mbases: int, patterns: str, out: str) -> None:
    """Write the full-size oracle to `out` (no JAX in this process)."""
    import pickle

    from kmer_tpu.utils import synth

    synth.ensure_pattern_file(DATA, N_SNPS, 21)
    workers = max(1, min(12, (os.cpu_count() or 2) - 2))
    exp = expected_outputs(mbases, patterns, workers)
    with open(out + ".tmp", "wb") as f:
        pickle.dump(exp, f)
    os.replace(out + ".tmp", out)


def vaf_counts(path: str):
    np = _np()
    rows = [ln.split("\t") for ln in open(path).read().splitlines()
            if ln and not ln.startswith("#") and not ln.startswith("CHR")]
    return np.array([[int(r[5]), int(r[6])] for r in rows], np.int64)


# ---------------------------------------------------------------------------
# children (these import JAX)

def _start_device(rehearse: bool):
    import jax

    d = jax.devices()[0]
    dev = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if dev["platform"] != "gpu" and not rehearse:
        raise SmokeError(f"first JAX device is {dev['platform']!r}, not a GPU")
    print("SMOKE_DEVICE " + json.dumps(dev), flush=True)
    return jax


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling since start."""

    def __init__(self):
        import jax

        self.s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_kw):
        if event.startswith("/jax/core/compile/"):
            self.s += duration


def child_kernels(rehearse: bool) -> None:
    np = _np()
    jax = _start_device(rehearse)
    import jax.numpy as jnp

    from kmer_tpu.io import native
    from kmer_tpu.kernels import bitonic, segops
    from kmer_tpu.pipeline import counter
    from kmer_tpu.table import compactor
    from kmer_tpu.utils import synth

    check(native.available(), "native FASTQ reader built and loaded")
    say(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    rng = np.random.default_rng(5)
    # one engine block: 150 bp reads + separator at the 10 M-base width
    # (SortCountEngine capacity), with 0.5% N bases, some lowercase
    cap = BLOCK_BASES + max(4096, BLOCK_BASES // 32)
    codes = next(synth.iter_read_codes(16))
    nr = BLOCK_BASES // 150 + 1
    rows = np.zeros((nr, 151), np.uint8)
    rows[:, :150] = synth.ACGT[codes[:nr]]
    clean = np.zeros(cap, np.uint8)
    clean[: rows.size] = rows.reshape(-1)
    dirty = clean.copy()
    body = dirty[: rows.size]
    body[rng.random(body.size) < 0.005] = ord("N")
    low = rng.random(body.size) < 0.01
    body[low] = body[low] | 0x20
    body[150::151] = 0  # separators stay separators
    d_dirty = jnp.asarray(dirty)
    for k in (15, 21, 31, 32):
        hi, lo, nk = counter._extract_step(d_dirty, k)
        got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
            np.asarray(lo).astype(np.uint64)
        keys, valid = flat_keys(dirty, k)
        check(int(nk) == int(valid.sum()),
              f"extract k={k}: {int(nk)} valid windows of {cap} bytes")
        check(bool((got[~valid] == np.uint64(SENT64)).all()),
              f"extract k={k}: sentinel on every invalid lane")
        if k < 32:
            check(bool(np.array_equal(got[valid], keys[valid])),
                  f"extract k={k}: every key equals the numpy oracle")
        else:
            check(len(np.unique(got[valid])) == 1,
                  "extract k=32: one key (reference shift semantics)")
    # the CLI's uniform-read paths: ASCII rows and 2-bit packed
    want31 = np.sort(canonical_windows(codes[:nr], 31).reshape(-1))
    hi, lo, _ = counter._extract_step_rows(jnp.asarray(clean), 31, 151)
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    check(bool(np.array_equal(np.sort(got[got != SENT64]), want31)),
          "extract rows path k=31: key multiset equals the oracle")
    cc = np.zeros(cap, np.uint8)
    cc[: rows.size] = np.concatenate(
        [codes[:nr], np.zeros((nr, 1), np.uint8)], 1).reshape(-1)
    q = cc.reshape(-1, 4).astype(np.uint32)
    packed = (q[:, 0] | q[:, 1] << 2 | q[:, 2] << 4 | q[:, 3] << 6).astype(
        np.uint8)
    hi, lo, _ = counter._extract_step_packed_structural(
        jnp.asarray(packed), jnp.uint32(rows.size), 31, 151)
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    check(bool(np.array_equal(np.sort(got[got != SENT64]), want31)),
          "extract packed path k=31: key multiset equals the oracle")
    # histogram core over 2^24 lanes with duplicates and sentinel padding
    n = 1 << 24
    kk = rng.integers(0, 3_000_000, n - 12345).astype(np.uint64)
    kk = hash64_u64(kk, 31)
    hi_np = np.full(n, 0xFFFFFFFF, np.uint32)
    lo_np = np.full(n, 0xFFFFFFFF, np.uint32)
    hi_np[: kk.size] = (kk >> np.uint64(32)).astype(np.uint32)
    lo_np[: kk.size] = kk.astype(np.uint32)
    w = rng.integers(1, 9, n).astype(np.uint32)
    w[kk.size:] = 0
    uniq, inv = np.unique(kk, return_inverse=True)
    cnt = np.bincount(inv, minlength=uniq.size)
    wcnt = np.bincount(inv, weights=w[: kk.size], minlength=uniq.size)
    d_hi, d_lo, d_w = jnp.asarray(hi_np), jnp.asarray(lo_np), jnp.asarray(w)
    for label, has_w, c, mx, mk in (
            ("unweighted", False, cnt, None, 1),
            ("weighted", True, wcnt.astype(np.int64), None, 1),
            ("clamped [2, 255]", False, cnt, 255, 2)):
        h, nd = compactor._hist_impl(d_hi, d_lo, d_w if has_w else d_hi,
                                     256, mx, mk, has_w)
        cc_ = c if mx is None else np.minimum(c, mx)
        keep = cc_ >= mk
        want = np.bincount(np.minimum(cc_[keep], 255), minlength=256)
        want[0] = 0
        check(bool(np.array_equal(np.asarray(h), want))
              and int(nd) == int(keep.sum()),
              f"histogram core {label}: equals numpy over {n} lanes")
    b = rng.integers(0, 400, n).astype(np.int32)
    m = rng.random(n) < 0.2
    h = segops.histogram(jnp.asarray(b), jnp.asarray(m), 256)
    check(bool(np.array_equal(np.asarray(h), np.bincount(
        np.minimum(b[m], 255), minlength=256))),
        f"scatter histogram: equals np.bincount over {n} lanes")
    # bitonic merge of two sorted 2^23-lane halves (stream-sorted mode)
    key = (hi_np.astype(np.uint64) << np.uint64(32)) | lo_np
    rng.shuffle(key)
    half = n // 2
    halves = np.concatenate([np.sort(key[:half]), np.sort(key[half:])])
    mh, ml = bitonic.merge_sorted_halves(
        jnp.asarray((halves >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(halves.astype(np.uint32)))
    merged = (np.asarray(mh).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(ml).astype(np.uint64)
    check(bool(np.array_equal(merged, np.sort(key))),
          f"bitonic merge: equals np.sort over {n} lanes")


def _run_tool(name: str, argv, out_dir: str) -> dict:
    """One CLI entry point in-process, stdout/stderr to files."""
    import jax

    from kmer_tpu.tools import get_tool

    os.makedirs(out_dir, exist_ok=True)
    so, se = (os.path.join(out_dir, f"{name}.{s}") for s in ("out", "err"))
    t0 = time.time()
    with open(so, "w") as fo, open(se, "w") as fe, \
            contextlib.redirect_stdout(fo), contextlib.redirect_stderr(fe):
        rc = get_tool(name)(list(argv))
    wall = time.time() - t0
    if rc:
        raise SmokeError(f"{name} {' '.join(argv)} exited {rc}: "
                         + open(se).read()[-2000:])
    stats = jax.devices()[0].memory_stats() or {}
    return {"tool": name, "wall_s": wall,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def _full_tools(reads: str, patterns: str, out_dir: str, clock) -> None:
    for name, argv in (
            ("kc-c4", ["-k31", reads]),
            ("vaf-counter", ["-k21", "-p", patterns, "-o",
                             os.path.join(out_dir, "reads.vaf"), reads]),
            ("yak-count", ["-b30", reads])):
        c0 = clock.s
        r = _run_tool(name, argv, out_dir)
        r["compile_s"] = clock.s - c0
        print("SMOKE_RUN " + json.dumps(r), flush=True)


def child_full(rehearse: bool, reads: str, patterns: str) -> None:
    _start_device(rehearse)
    clock = CompileClock()
    _full_tools(reads, patterns, os.path.join(OUT, "full"), clock)


def child_mesh(rehearse: bool, reads: str, patterns: str) -> None:
    jax = _start_device(rehearse)
    import numpy as np

    from kmer_tpu.dist import sharded
    from kmer_tpu.pipeline import counter

    if len(jax.devices()) != 4:
        raise SmokeError(f"--four-cards needs 4 devices, found "
                         f"{len(jax.devices())}")
    clock = CompileClock()
    for mode, env in (("mesh", None), ("single", "0")):
        if env is None:
            os.environ.pop("KMER_TPU_FORCE_MESH", None)
        else:
            os.environ["KMER_TPU_FORCE_MESH"] = env
        eng = type(counter.make_count_engine(k=31)).__name__
        print("SMOKE_ENGINE " + json.dumps({"mode": mode, "engine": eng}),
              flush=True)
        _full_tools(reads, patterns, os.path.join(OUT, mode), clock)
    os.environ.pop("KMER_TPU_FORCE_MESH", None)
    # the routing all_to_all of the CLI's (ASCII rows) step must span
    # every device of the mesh
    mesh = sharded.make_mesh()
    step = sharded.sharded_extract_step_fn(mesh, 31, 4096, 151, "ascii")
    rows = jax.ShapeDtypeStruct((4, 1 << 16), np.uint8)
    hlo = step.lower(rows).compile().as_text()
    groups = re.findall(r"all-to-all[^\n]*replica_groups=(\S+)", hlo)
    print("SMOKE_A2A " + json.dumps({"mesh": dict(mesh.shape),
                                     "replica_groups": groups}), flush=True)
    sys.path.insert(0, ROOT)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    print("SMOKE_DRYRUN ok", flush=True)


# ---------------------------------------------------------------------------
# parent

def _child_env(rehearse: bool, four: bool = False, cpu: bool = False) -> dict:
    env = dict(os.environ)
    env.pop("KMER_TPU_FORCE_MESH", None)
    if cpu or rehearse:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)
    if rehearse and four:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=4")
    return env


def run_child(args, env, timeout: float, label: str):
    """Run `python chip_smoke.py --child ...`, echo its output, fail on a
    non-zero exit.  Returns its stdout lines."""
    t0 = time.time()
    p = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                       env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    for ln in p.stdout.splitlines():
        if not ln.startswith("SMOKE_"):
            say(ln)
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-6000:])
        raise SmokeError(f"{label} child exited {p.returncode}")
    say(f"  ({label}: {time.time() - t0:.1f} s wall)")
    return p.stdout.splitlines()


def tagged(lines, tag: str):
    return [json.loads(ln[len(tag) + 1:]) for ln in lines
            if ln.startswith(tag + " ")]


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return r.stdout.strip() or r.stderr.strip()


_TIMES = re.compile(rb"\d+\.\d+ sec")


def _fixture_cmds(d: str):
    r = os.path.join(FIX, "reads_small.fq.gz")
    bed = os.path.join(FIX, "snps_small.bed")
    genome = os.path.join(FIX, "genome_small.fa.gz")
    a1 = os.path.join(FIX, "sampleA1.fq.gz")
    pat = os.path.join(d, "pat.txt")
    return [
        ("kc-c1", ["-k21", r], []),
        ("kc-c2", ["-k31", r], []),
        ("kc-c4", ["-k31", r], []),
        ("kc-c4", ["-k15", r], []),
        ("yak-count", ["-k21", "-b14", r], []),
        ("snp-pattern-gen", ["-k21", "-b", bed, "-f", genome, "-o", pat],
         [pat]),
        ("vaf-counter", ["-k21", "-p", pat, "-o", os.path.join(d, "a.vaf"),
                         a1], [os.path.join(d, "a.vaf")]),
        ("ed-vaf-counter", ["-p", pat, "-o", os.path.join(d, "ed.vaf"), a1],
         [os.path.join(d, "ed.vaf")]),
    ]


def _run_fixture_side(d: str, env: dict):
    """Run every fixture command in order (later ones read earlier
    outputs) in directory d; returns [(stdout, stderr, {file: bytes})]."""
    os.makedirs(d, exist_ok=True)
    res = []
    for tool, argv, outs in _fixture_cmds(d):
        p = subprocess.run([os.path.join(ROOT, "ktc"), tool] + argv,
                           env=env, capture_output=True, timeout=900,
                           cwd=d)
        files = {}
        for f in outs:
            with open(f, "rb") as fh:
                files[os.path.basename(f)] = fh.read()
        res.append((p.returncode, p.stdout, p.stderr, files))
    return res


def phase_fixtures(rehearse: bool) -> None:
    from concurrent.futures import ThreadPoolExecutor

    base = os.path.join(OUT, "fixtures")
    shutil.rmtree(base, ignore_errors=True)
    with ThreadPoolExecutor(1) as ex:
        cpu = ex.submit(_run_fixture_side, os.path.join(base, "cpu"),
                        _child_env(rehearse, cpu=True))
        t0 = time.time()
        gpu = _run_fixture_side(os.path.join(base, "gpu"),
                                _child_env(rehearse))
        say(f"  (device side: {time.time() - t0:.1f} s wall)")
        cpu = cpu.result()
    for (tool, argv, _), g, c in zip(
            _fixture_cmds(os.path.join(base, "gpu")), gpu, cpu):
        label = f"{tool} {' '.join(os.path.basename(a) for a in argv)}"
        if g[0] != 0 or c[0] != 0:
            sys.stderr.write(g[2].decode(errors="replace")[-3000:])
            raise SmokeError(f"fixture {label}: exit {g[0]} (device) / "
                             f"{c[0]} (cpu)")
        if not (g[1] or any(g[3].values())):
            raise SmokeError(f"fixture {label}: produced no output")
        check(g[1] == c[1],
              f"fixture {label}: stdout identical ({len(g[1])} bytes)")
        check(_TIMES.sub(b"T sec", g[2]) == _TIMES.sub(b"T sec", c[2]),
              f"fixture {label}: stderr identical ({len(g[2])} bytes; "
              f"elapsed-time figures masked)")
        for name in g[3]:
            check(g[3][name] == c[3][name],
                  f"fixture {label}: {name} identical "
                  f"({len(g[3][name])} bytes)")


def _start_data(mbases: int):
    """Write the seeded reads and patterns in a background process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from kmer_tpu.utils import synth\n"
            "synth.ensure_reads_file(%r, %d)\n"
            "synth.ensure_pattern_file(%r, %d, 21)\n"
            % (ROOT, DATA, mbases, DATA, N_SNPS))
    return subprocess.Popen([sys.executable, "-c", code])


def _compare_full(out_dir: str, exp: dict, label: str) -> None:
    for tool in ("kc-c4", "yak-count"):
        got = open(os.path.join(out_dir, f"{tool}.out")).read()
        check(got == exp[tool],
              f"{label} {tool}: histogram equals the oracle exactly "
              f"({exp['n_distinct']} distinct 31-mers)")
    got = vaf_counts(os.path.join(out_dir, "reads.vaf"))
    check(got.shape == exp["vaf"].shape
          and bool((got == exp["vaf"]).all()),
          f"{label} vaf-counter: REF/ALT counts of {got.shape[0]} SNPs "
          f"equal the oracle ({int(got.sum())} k-mer hits)")


def _report_runs(lines) -> None:
    for r in tagged(lines, "SMOKE_RUN"):
        say(f"  setup fact: {r['tool']} wall {r['wall_s']:.2f} s, "
            f"compile {r['compile_s']:.2f} s, peak_bytes_in_use "
            f"{r['peak_bytes_in_use']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at a small size; prints no result")
    ap.add_argument("--mbases", type=int, default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--reads", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--patterns", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "kmer_tpu")) or \
            not os.path.exists(os.path.join(ROOT, "ktc")):
        sys.stderr.write("chip_smoke.py: run it from a checkout of the "
                         "repository (kmer_tpu/ and ktc not found)\n")
        return 2
    sys.path.insert(0, ROOT)
    import kmer_tpu  # noqa: F401  (compile-cache rule, no JAX import)

    if a.child:
        rehearse = bool(os.environ.get("CHIP_SMOKE_REHEARSE"))
        try:
            if a.child == "kernels":
                child_kernels(rehearse)
            elif a.child == "full":
                child_full(rehearse, a.reads, a.patterns)
            elif a.child == "mesh":
                child_mesh(rehearse, a.reads, a.patterns)
            elif a.child == "oracle":
                child_oracle(a.mbases, a.patterns, a.out)
        except SmokeError as e:
            sys.stderr.write(f"FAILED: {e}\n")
            return 1
        return 0

    mbases = a.mbases or (4 if a.rehearse else FULL_MBASES)
    if a.rehearse:
        os.environ["CHIP_SMOKE_REHEARSE"] = "1"
    os.makedirs(OUT, exist_ok=True)
    t_start = time.time()
    data = _start_data(mbases)
    patterns = os.path.join(DATA, f"patterns_{N_SNPS}_k21.txt")
    oracle_out = os.path.join(OUT, "oracle.pkl")
    if os.path.exists(oracle_out):
        os.unlink(oracle_out)
    oracle = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", "oracle",
         "--mbases", str(mbases), "--patterns", patterns,
         "--out", oracle_out], cwd=ROOT)
    try:
        say("phase 0: device")
        smi = nvidia_smi()
        say(f"  nvidia-smi: {smi}")
        if a.four_cards:
            env = _child_env(a.rehearse, four=True)
            dev = None
        else:
            say("phase 1: kernels against numpy at the 10 M-base block")
            lines = run_child(["--child", "kernels"], _child_env(a.rehearse),
                              900, "kernels")
            dev = tagged(lines, "SMOKE_DEVICE")[0]
            say(f"  device: {json.dumps(dev)}")
            say("phase 2: fixtures, device against JAX_PLATFORMS=cpu")
            phase_fixtures(a.rehearse)
            env = _child_env(a.rehearse)
        if data.wait() != 0:
            raise SmokeError("writing the seeded reads failed")
        from kmer_tpu.utils import synth

        reads = synth.reads_path(DATA, mbases)
        phase = "mesh" if a.four_cards else "full"
        say(f"phase {'4' if a.four_cards else '3'}: {mbases} Mbases through "
            f"the CLI entry points ({phase})")
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", phase,
             "--reads", reads, "--patterns", patterns],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=ROOT)
        so, se = p.communicate(timeout=1800)
        if oracle.wait() != 0:
            raise SmokeError("the numpy oracle failed")
        import pickle

        with open(oracle_out, "rb") as f:
            exp = pickle.load(f)
        say(f"  (numpy oracle, started with phase 0: "
            f"{exp['seconds']:.1f} s)")
        lines = so.splitlines()
        for ln in lines:
            if not ln.startswith("SMOKE_"):
                say(ln)
        if p.returncode != 0:
            sys.stderr.write(se[-6000:])
            raise SmokeError(f"{phase} child exited {p.returncode}")
        dev = tagged(lines, "SMOKE_DEVICE")[0]
        _report_runs(lines)
        if a.four_cards:
            engines = {e["mode"]: e["engine"]
                       for e in tagged(lines, "SMOKE_ENGINE")}
            check(engines.get("mesh") == "MeshSortCountEngine"
                  and engines.get("single") == "SortCountEngine",
                  f"engines: {engines}")
            for mode in ("mesh", "single"):
                _compare_full(os.path.join(OUT, mode), exp, mode)
            for tool in ("kc-c4", "vaf-counter", "yak-count"):
                f = "reads.vaf" if tool == "vaf-counter" else f"{tool}.out"
                check(open(os.path.join(OUT, "mesh", f)).read()
                      == open(os.path.join(OUT, "single", f)).read(),
                      f"{tool}: mesh output identical to one device")
            a2a = tagged(lines, "SMOKE_A2A")[0]
            spans = [g for g in a2a["replica_groups"]
                     if g.rstrip(",") in ("{{0,1,2,3}}", "[1,4]<=[4]")]
            check(bool(spans) and len(spans) == len(a2a["replica_groups"]),
                  f"all_to_all spans all four devices: mesh "
                  f"{a2a['mesh']}, replica_groups {a2a['replica_groups']}")
            check(any(ln == "SMOKE_DRYRUN ok" for ln in lines),
                  "__graft_entry__.dryrun_multichip(4)")
        else:
            _compare_full(os.path.join(OUT, "full"), exp, "device")
        say(f"  (smoke total: {time.time() - t_start:.1f} s wall)")
    except (SmokeError, subprocess.TimeoutExpired) as e:
        for proc in (data, oracle):
            if proc.poll() is None:
                proc.kill()
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1
    say(f"card: {smi}")
    if a.rehearse:
        say(json.dumps({"rehearsal": "passed", "device": dev}))
        return 0
    say(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
