#!/usr/bin/env python3
"""A/B timings behind the device path's kernel and default choices, on one GPU.

    python scripts/ab_kernels.py [--sections check,extract,hist,merge,e2e]
                                 [--cfgs NAME,...] [--reps N]
                                 [--out chiprun_out/ab.jsonl] [--rehearse]
    python scripts/ab_kernels.py --sections cli [--cfgs ...] [--reps N]

Every measurement is one JSON line, printed and appended to --out, with
the card's `nvidia-smi` name and power limit.  A kernel time is the mean
of 20 back-to-back calls after a warm-up call, ended by block_until_ready;
the kernels of a section are timed in the order A B ... Z, then Z ... B A
(`pass` 0 and 1), after a second of spinning the first one so that the
card's clocks are up.

  check    the Pallas-Triton candidate below, compiled for the card at
           four block/warp choices, exact against the package's XLA
           extraction at k = 15, 21, 31, 32 on one engine block
  extract  one engine block (10,312,500 bytes: 150 bp reads, separators,
           0.5% N bases), k = 31: the package's XLA extraction
           (windowed-OR validity), the same keys with a cumsum validity,
           and the candidate at the four choices; flat and uniform-row
           (CLI default) forms
  hist     the finalize histogram over 200 Mi lanes (~47 M distinct
           keys, 2% sentinel tail), the 2-key sort alone, and the
           segment-length scatter-add with masked lanes spread over
           spill bins against all of them parked in bin 0
  merge    bitonic merge of two sorted halves against a fresh 2-key sort
           of the same lanes, at 2^27 and 2^28 lanes
  e2e      kc-c4 -k31's engine over 256 Mbases of seeded reads, warm, per
           configuration of stream-sort, packed ingest and uploader
           threads (--cfgs, default all): one warm-up pass each, then
           --reps passes per configuration, alternately in the order
           A B ... and ... B A
  cli      the same as `./ktc kc-c4 -k31 reads.fq.gz`, one process per
           pass, with the persistent compile cache warmed by a first
           pass per configuration: what a user who runs the tool again
           waits for.  Run it alone: this process then keeps off the
           card's memory (no preallocation) so each tool process gets it.

The Pallas-Triton extraction lives only in this script: it lost to XLA on
the H100 (PERF.md), so the package does not carry it.

Without --rehearse the script fails unless JAX's first device is a GPU.
--rehearse runs every section on the CPU at a tiny size, with the
candidate in interpret mode.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from kmer_tpu.kernels import bitonic, segops  # noqa: E402
from kmer_tpu.kernels import u64 as u  # noqa: E402
from kmer_tpu.kernels.encode import encode_bases  # noqa: E402
from kmer_tpu.kernels.hash64 import hash64  # noqa: E402
from kmer_tpu.kernels.kmer import extract_canonical  # noqa: E402
from kmer_tpu.pipeline import counter  # noqa: E402
from kmer_tpu.table import compactor  # noqa: E402
from kmer_tpu.utils import synth  # noqa: E402

U32, I32 = jnp.uint32, jnp.int32
SENT = 0xFFFFFFFF
ROW = synth.READ_LEN + 1
TRITON_CFGS = ((512, 4), (1024, 4), (2048, 8), (4096, 8))
E2E_CFGS = {  # name -> environment overrides of the engine's defaults
    "ascii_t2": {},
    "ascii_t1": {"KMER_TPU_UPLOAD_THREADS": "1"},
    "ascii_t4": {"KMER_TPU_UPLOAD_THREADS": "4"},
    "ascii_t16": {"KMER_TPU_UPLOAD_THREADS": "16"},
    "packed_t2": {"KMER_TPU_PACKED": "1"},
    "stream_ascii_t2": {"KMER_TPU_STREAM_SORT": "1"},
    "stream_packed_t2": {"KMER_TPU_STREAM_SORT": "1", "KMER_TPU_PACKED": "1"},
}


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


class Log:
    def __init__(self, path: str, card: str):
        self.path, self.card = path, card
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, **rec) -> None:
        rec["card"] = self.card
        line = json.dumps(rec)
        print(line, flush=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")


def spin(fn, *args, seconds: float = 1.0) -> None:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        jax.block_until_ready(fn(*args))


def mean_ms(fn, *args, reps: int = 20) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return round((time.perf_counter() - t0) / reps * 1e3, 4)


# ---------------------------------------------------------------------------
# the Pallas-Triton candidate: one block of positions per program, the
# k-1-byte halo read by masked loads, a partial n_kmers per program summed
# by XLA, nothing carried between programs


def triton_extract(buf, k: int, block: int, warps: int,
                   interpret: bool = False):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    n = buf.shape[0]
    grid = pl.cdiv(n, block)

    def kernel(x_ref, hi_ref, lo_ref, nk_ref):
        pos = pl.program_id(0) * block + jnp.arange(block, dtype=I32)
        in_buf = pos < n
        zero = jnp.zeros((block,), U32)
        fwd_lo = fwd_hi = rev_lo = rev_hi = zero
        bad = pos < k - 1  # no full window before position k-1
        for d in range(k):
            src = pos - d
            ok = (src >= 0) & (src < n)
            a = plt.load(x_ref.at[jnp.clip(src, 0, n - 1)], mask=ok,
                         other=0)
            code = encode_bases(a)
            bad = bad | (code >= 4)
            c = jnp.where(code >= 4, 0, code).astype(U32)
            bp, bq = 2 * d, 2 * (k - 1 - d)
            if bp < 32:
                fwd_lo = fwd_lo | (c << bp)
            else:
                fwd_hi = fwd_hi | (c << (bp - 32))
            if bq < 32:
                rev_lo = rev_lo | ((U32(3) - c) << bq)
            else:
                rev_hi = rev_hi | ((U32(3) - c) << (bq - 32))
        canon = u.min_(u.U64(fwd_hi, fwd_lo), u.U64(rev_hi, rev_lo))
        if k == 32:  # the reference's shift-by-64 mask (kmer.py)
            canon = u.U64(zero, zero)
        canon = hash64(canon, 2 * k)
        valid = ~bad & in_buf
        idx = jnp.clip(pos, 0, n - 1)
        plt.store(hi_ref.at[idx], jnp.where(valid, canon.hi, U32(SENT)),
                  mask=in_buf)
        plt.store(lo_ref.at[idx], jnp.where(valid, canon.lo, U32(SENT)),
                  mask=in_buf)
        nk_ref[pl.program_id(0)] = jnp.sum(valid.astype(I32))

    hi, lo, nk = pl.pallas_call(
        kernel, grid=(grid,),
        out_shape=(jax.ShapeDtypeStruct((n,), U32),
                   jax.ShapeDtypeStruct((n,), U32),
                   jax.ShapeDtypeStruct((grid,), I32)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps),
        interpret=interpret, name=f"extract_k{k}",
    )(buf)
    return hi, lo, jnp.sum(nk)


def rows_of(step):
    """The uniform-row slice of counter._extract_step_rows over any flat
    extraction."""
    def f(buf, k):
        hi, lo, nk = step(buf, k)
        span = buf.shape[0] // ROW * ROW
        cut = lambda p: p[:span].reshape(-1, ROW)[:, k - 1:ROW - 1].reshape(-1)
        return cut(hi), cut(lo), nk
    return f


def cumsum_extract(buf, k: int):
    """The package's keys with the cumsum validity it used before (the
    windowed OR it dropped is dead code here and is not computed)."""
    codes = encode_bases(buf)
    keys = extract_canonical(codes, k).kmer
    bad = (codes >= 4).astype(I32)
    c0 = jnp.concatenate([jnp.zeros((1,), I32), jnp.cumsum(bad)])
    valid = jnp.concatenate([jnp.zeros((k - 1,), jnp.bool_),
                             (c0[k:] - c0[:-k]) == 0])
    return (jnp.where(valid, keys.hi, U32(SENT)),
            jnp.where(valid, keys.lo, U32(SENT)),
            jnp.sum(valid.astype(I32)))


def engine_block(cap: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = next(synth.iter_read_codes(16))
    nr = min(cap // ROW, codes.shape[0])
    rows = np.zeros((nr, ROW), np.uint8)
    rows[:, :-1] = synth.ACGT[codes[:nr]]
    body = rows[:, :-1]
    body[rng.random(body.shape) < 0.005] = ord("N")
    buf = np.zeros(cap, np.uint8)
    buf[: rows.size] = rows.reshape(-1)
    return buf


def sec_check(log, cap: int, interpret: bool) -> None:
    d = jnp.asarray(engine_block(cap))
    for k in (15, 21, 31, 32):
        want = [np.asarray(x) for x in counter._extract_step(d, k)]
        for b, w in TRITON_CFGS:
            f = jax.jit(lambda x, k=k, b=b, w=w: triton_extract(
                x, k, b, w, interpret))
            got = [np.asarray(x) for x in f(d)]
            ok = all(np.array_equal(g, x) for g, x in zip(got, want))
            log(sec="check", variant=f"triton_b{b}_w{w}", k=k, exact=ok)
            if not ok:
                raise SystemExit(f"triton b{b} w{w} k={k} differs from XLA")


def sec_extract(log, cap: int, interpret: bool) -> None:
    d = jnp.asarray(engine_block(cap))
    k = 31
    flat = {"xla_or": jax.jit(counter._extract_planes, static_argnames="k"),
            "xla_cumsum": jax.jit(cumsum_extract, static_argnames="k")}
    for b, w in TRITON_CFGS:
        flat[f"triton_b{b}_w{w}"] = jax.jit(
            lambda x, k, b=b, w=w: triton_extract(x, k, b, w, interpret),
            static_argnames="k")
    runs = [("extract", name, partial(f, k=k)) for name, f in flat.items()]
    runs += [("extract_rows", name,
              partial(jax.jit(rows_of(f), static_argnames="k"), k=k))
             for name, f in flat.items()]
    for sec, name, f in runs:  # compile everything before any timing
        jax.block_until_ready(f(d))
    spin(runs[0][2], d)
    for p, order in enumerate((runs, runs[::-1])):
        for sec, name, f in order:
            log(sec=sec, variant=name, k=k, bytes=cap, ms=mean_ms(f, d),
                **{"pass": p})


def random_planes(n: int, n_keys: int, seed: int):
    """n lanes of hash64 keys drawn from n_keys values, with a 2% sentinel
    tail, made on the device."""
    x = jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, n_keys,
                           dtype=I32).astype(U32)
    key = hash64(u.U64(jnp.zeros_like(x), x), 62)
    tail = jnp.arange(n) >= n - n // 50
    return (jnp.where(tail, U32(SENT), key.hi),
            jnp.where(tail, U32(SENT), key.lo))


def sec_hist(log, n: int) -> None:
    hi, lo = jax.jit(random_planes, static_argnums=(0, 1, 2))(
        n, n * 48 // 210, 1)
    f = lambda a, b: compactor._hist_impl(a, b, a, 256, None, 1, False)
    _, nd = f(hi, lo)
    log(sec="hist_full", lanes=n, ms=mean_ms(f, hi, lo, reps=5),
        n_distinct=int(nd))
    log(sec="sort2", lanes=n,
        ms=mean_ms(compactor._sort_run2, hi, lo, reps=5))
    # segment lengths after the sort: ~22% of lanes end a segment
    r = jax.random.PRNGKey(2)
    bins = jax.random.randint(r, (n,), 1, 300, dtype=I32)
    mask = jax.random.uniform(jax.random.fold_in(r, 1), (n,)) < 0.22
    spread = jax.jit(segops.histogram, static_argnums=2)

    @jax.jit
    def parked(b, m):
        idx = jnp.where(m, jnp.minimum(b, 255), 0)
        return jnp.zeros((256,), I32).at[idx].add(1).at[0].set(0)

    agree = bool(np.array_equal(np.asarray(spread(bins, mask, 256)),
                                np.asarray(parked(bins, mask))))
    log(sec="hist_scatter", variant="spread", lanes=n, agree=agree,
        ms=mean_ms(lambda b, m: spread(b, m, 256), bins, mask, reps=5))
    log(sec="hist_scatter", variant="parked_bin0", lanes=n,
        ms=mean_ms(parked, bins, mask, reps=5))


def sec_merge(log, sizes) -> None:
    for n in sizes:
        hi, lo = jax.jit(random_planes, static_argnums=(0, 1, 2))(
            n, n // 4, 3)
        h = n // 2
        a = compactor._sort_run2(hi[:h], lo[:h])
        b = compactor._sort_run2(hi[h:], lo[h:])
        mh, ml = jnp.concatenate([a[0], b[0]]), jnp.concatenate([a[1], b[1]])
        del hi, lo, a, b
        m = bitonic.merge_sorted_halves(mh, ml)
        s = compactor._sort_run2(mh, ml)
        same = bool(jnp.array_equal(m[0], s[0]) & jnp.array_equal(m[1], s[1]))
        del m, s
        log(sec="merge", lanes=n, same=same,
            merge_ms=mean_ms(bitonic.merge_sorted_halves, mh, ml, reps=5),
            sort_ms=mean_ms(compactor._sort_run2, mh, ml, reps=5))


def e2e_pass(reads: str, name: str) -> dict:
    for var in ("KMER_TPU_UPLOAD_THREADS", "KMER_TPU_PACKED",
                "KMER_TPU_STREAM_SORT"):
        os.environ.pop(var, None)
    os.environ.update(E2E_CFGS[name])
    t0 = time.perf_counter()
    eng = counter.SortCountEngine(31)
    eng.count_paths([reads])
    t1 = time.perf_counter()
    h = np.asarray(eng.hist(256))
    t2 = time.perf_counter()
    return {"cfg": name, "wall_s": round(t2 - t0, 3),
            "loop_s": round(eng.stats.loop_s, 3),
            "finalize_s": round(t2 - t1, 3), "stages": eng.stats.report(),
            "n_distinct": int(eng._n_distinct), "kmers": eng.total_kmers,
            "hist_sum": int(h.sum())}


def alternating(names, reps: int):
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            yield rep, name


def sec_e2e(log, reads: str, names, reps: int) -> None:
    for name in names:  # compiles each configuration's programs
        log(sec="e2e_warmup", **e2e_pass(reads, name))
    seen = set()
    for rep, name in alternating(names, reps):
        r = e2e_pass(reads, name)
        seen.add((r["n_distinct"], r["kmers"], r["hist_sum"]))
        log(sec="e2e", rep=rep, **r)
    log(sec="e2e_agree", configs=len(names), same_result=len(seen) == 1)


def cli_pass(reads: str, name: str) -> dict:
    env = dict(os.environ)
    for var in ("KMER_TPU_UPLOAD_THREADS", "KMER_TPU_PACKED",
                "KMER_TPU_STREAM_SORT", "XLA_PYTHON_CLIENT_PREALLOCATE"):
        env.pop(var, None)
    env.update(E2E_CFGS[name])
    t0 = time.perf_counter()
    r = subprocess.run([os.path.join(ROOT, "ktc"), "kc-c4", "-k31", reads],
                       env=env, capture_output=True, check=True)
    return {"cfg": name, "wall_s": round(time.perf_counter() - t0, 3),
            "stdout": r.stdout}


def sec_cli(log, reads: str, names, reps: int) -> None:
    for name in names:  # fills the persistent compile cache
        r = cli_pass(reads, name)
        log(sec="cli_warmup", cfg=name, wall_s=r["wall_s"])
    seen = set()
    for rep, name in alternating(names, reps):
        r = cli_pass(reads, name)
        seen.add(r.pop("stdout"))
        log(sec="cli", rep=rep, **r)
    log(sec="cli_agree", configs=len(names), same_output=len(seen) == 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default="check,extract,hist,merge,e2e")
    ap.add_argument("--cfgs", default=",".join(E2E_CFGS))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "ab.jsonl"))
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    sections = args.sections.split(",")
    names = args.cfgs.split(",")
    if "cli" in sections:
        if len(sections) > 1:
            raise SystemExit("run the cli section alone")
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"first JAX device is {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    card = nvidia_smi() if not args.rehearse else "cpu rehearsal"
    print(card, flush=True)
    log = Log(args.out, card)
    small = args.rehearse
    mbases = 1 if small else 256
    data = os.path.join(ROOT, "bench_data")
    maker = None
    if {"e2e", "cli"} & set(sections):  # write the reads meanwhile
        maker = subprocess.Popen([sys.executable, "-c",
                                  "import sys; sys.path.insert(0, %r)\n"
                                  "from kmer_tpu.utils import synth\n"
                                  "synth.ensure_reads_file(%r, %d)\n"
                                  % (ROOT, data, mbases)])
    cap = (1 << 16) if small else 10_000_000 + 10_000_000 // 32
    t_all = time.perf_counter()
    for sec in sections:
        t0 = time.perf_counter()
        if sec == "check":
            sec_check(log, cap, interpret=small)
        elif sec == "extract":
            sec_extract(log, cap, interpret=small)
        elif sec == "hist":
            sec_hist(log, (1 << 16) if small else 200 << 20)
        elif sec == "merge":
            sec_merge(log, (1 << 12,) if small else (1 << 27, 1 << 28))
        elif sec in ("e2e", "cli"):
            if maker.wait() != 0:
                raise SystemExit("writing the seeded reads failed")
            run = sec_e2e if sec == "e2e" else sec_cli
            run(log, synth.reads_path(data, mbases), names, args.reps)
        else:
            raise SystemExit(f"unknown section {sec!r}")
        log(sec=sec, section_s=round(time.perf_counter() - t0, 2))
    print(f"total {time.perf_counter() - t_all:.1f} s; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
