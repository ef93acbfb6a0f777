"""Deferred yak admission (pipeline.yak_admit) vs a lane-by-lane
sequential oracle of the reference's bloom-gated insertion
(/root/reference/yak-count.c:91-108,150-177): per-batch
newly-admitted-distinct counts and the cumulative total must match the
strictly sequential semantics exactly, including bloom false positives
and same-call duplicate probes (h2 cycling, yak-count.c:100-105)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kmer_tpu.kernels import bloom  # noqa: E402
from kmer_tpu.kernels import u64 as u  # noqa: E402
from kmer_tpu.pipeline.yak_admit import DeferredYakAdmission  # noqa: E402

SENT = 0xFFFFFFFF


def _rand_planes(rng, n, n_keys, key_bits=40, sent_frac=0.05):
    """Random key planes drawn from a pool of n_keys distinct keys
    (repeats are the point), with some sentinel lanes sprinkled in."""
    pool = rng.choice(1 << key_bits, size=n_keys, replace=False).astype(
        np.uint64
    )
    keys = pool[rng.integers(0, n_keys, n)]
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sent = rng.random(n) < sent_frac
    hi[sent] = SENT
    lo[sent] = SENT
    return hi, lo


def _oracle(hi, lo, bounds, spec, use_bloom):
    """Strictly sequential simulation: walk lanes in order, probe the
    bloom bit-by-bit with test-AFTER-set within each lane's own call
    (cnt += bit; bit = 1 — yak-count.c:103-104), admit on all-set,
    count each key's first admission in its batch."""
    n = len(hi)
    if use_bloom:
        probes = bloom._probe_indices(
            u.U64(jnp.asarray(hi), jnp.asarray(lo)), spec
        )
        probes = np.stack([np.asarray(p) for p in probes], axis=1)
        bits = np.zeros(1 << spec.n_shift, bool)
    seen = set()
    per_batch = [0] * len(bounds)
    b = 0
    for i in range(n):
        while b < len(bounds) and i >= bounds[b]:
            b += 1
        if hi[i] == SENT and lo[i] == SENT:
            continue
        if use_bloom:
            cnt = 0
            for j in probes[i]:
                cnt += bits[j]
                bits[j] = True
            admit = cnt == spec.n_hashes
        else:
            admit = True
        if admit:
            key = (int(hi[i]) << 32) | int(lo[i])
            if key not in seen:
                seen.add(key)
                per_batch[min(b, len(bounds) - 1)] += 1
    return per_batch, len(seen)


def _drive(hi, lo, bounds, spec, use_bloom, block=997, budget=1 << 30,
           stream=None):
    adm = DeferredYakAdmission(spec, use_bloom, budget_bytes=budget,
                               stream_sorted=stream)
    bset = set(bounds)
    start = 0
    cut_points = sorted(bset | set(range(block, len(hi), block)))
    for end in cut_points + [len(hi)]:
        if end <= start:
            continue
        adm.add_block(
            jnp.asarray(hi[start:end]), jnp.asarray(lo[start:end]),
            batch_end=end in bset,
        )
        start = end
    return adm.finish()


# a tiny bloom (2^14 bits over 2^4 subtables = 2 blocks each) forces
# heavy bit sharing -> lots of false positives and in-batch collision
# order dependence; n_hashes=4 over 512-bit blocks makes h2==256
# duplicate probes routine at this key count
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "n,n_keys,n_shift,use_bloom",
    [
        (6000, 900, 14, True),
        (6000, 900, 22, True),   # sparse bloom: few FPs
        (4000, 700, 14, False),  # no bloom: first-occurrence counting
    ],
)
def test_deferred_vs_sequential_oracle(seed, n, n_keys, n_shift, use_bloom):
    rng = np.random.default_rng(seed)
    hi, lo = _rand_planes(rng, n, n_keys)
    n_batches = int(rng.integers(1, 6))
    bounds = sorted(
        rng.choice(np.arange(1, n), n_batches - 1, replace=False).tolist()
    ) + [n]
    spec = bloom.BloomSpec(4, n_shift, 4) if use_bloom else None
    want = _oracle(hi, lo, bounds, spec, use_bloom)
    got_pb, got_tot = _drive(hi, lo, bounds, spec, use_bloom)
    assert list(got_pb) == want[0]
    assert got_tot == want[1]


def test_budget_trips_are_invisible(monkeypatch):
    """A budget small enough to force a compaction per block must not
    change any total (the first-2 fold is exact under re-compaction)."""
    rng = np.random.default_rng(7)
    hi, lo = _rand_planes(rng, 5000, 800)
    bounds = [1700, 3400, 5000]
    spec = bloom.BloomSpec(4, 14, 4)
    a = _drive(hi, lo, bounds, spec, True)
    b = _drive(hi, lo, bounds, spec, True, block=333, budget=1)
    assert list(a[0]) == list(b[0]) and a[1] == b[1]


def test_lane_index_overflow_guard():
    adm = DeferredYakAdmission(None, False)
    adm._base = (1 << 32) - (1 << 20)
    with pytest.raises(RuntimeError, match="KMER_TPU_FAST_YAK"):
        adm.add_block(
            jnp.full((1 << 21,), SENT, jnp.uint32),
            jnp.full((1 << 21,), SENT, jnp.uint32),
            batch_end=True,
        )


# -- stream-sorted accumulation (KMER_TPU_STREAM_SORT=1 mode, forced here) --
#
# The stream ladder sorts each chunk as it arrives and folds with the
# 3-plane bitonic merge; mode must be invisible in every output.


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("use_bloom", [True, False])
def test_stream_mode_matches_classic(seed, use_bloom):
    rng = np.random.default_rng(seed)
    hi, lo = _rand_planes(rng, 6000, 900)
    bounds = [2100, 4300, 6000]
    spec = bloom.BloomSpec(4, 14, 4) if use_bloom else None
    a = _drive(hi, lo, bounds, spec, use_bloom, stream=False)
    b = _drive(hi, lo, bounds, spec, use_bloom, stream=True)
    assert list(a[0]) == list(b[0]) and a[1] == b[1]


def test_stream_mode_budget_trips_are_invisible():
    """Stream-mode budget trips (ladder fold -> merge with the standing
    first-2 run -> keep rank sort) must not change any total."""
    rng = np.random.default_rng(11)
    hi, lo = _rand_planes(rng, 5000, 800)
    bounds = [1700, 3400, 5000]
    spec = bloom.BloomSpec(4, 14, 4)
    a = _drive(hi, lo, bounds, spec, True, stream=False)
    b = _drive(hi, lo, bounds, spec, True, block=333, budget=1, stream=True)
    assert list(a[0]) == list(b[0]) and a[1] == b[1]


def test_fp_unpacked_fallback_matches_oracle(monkeypatch):
    """At >= 2^31 probe entries the (pos << 1 | verdict) packing cannot
    fit u32 and the two-plane restore path runs instead; force it at
    test scale (fresh n so no cached packed trace is reused) and pin it
    against the sequential oracle."""
    import kmer_tpu.pipeline.yak_admit as ya

    monkeypatch.setattr(ya, "_pack_ok", lambda m, nh: False)
    rng = np.random.default_rng(5)
    n = 7001
    hi, lo = _rand_planes(rng, n, 950)
    bounds = [2345, 5678, n]
    spec = bloom.BloomSpec(4, 14, 4)
    want = _oracle(hi, lo, bounds, spec, True)
    got_pb, got_tot = _drive(hi, lo, bounds, spec, True)
    assert list(got_pb) == want[0]
    assert got_tot == want[1]
