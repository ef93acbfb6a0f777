"""Bitonic merge (kernels/bitonic.py) vs lax.sort ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_tpu.kernels import bitonic


def _sorted_halves(rng, n, sent_frac=0.0):
    hi = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if sent_frac:
        m = rng.random(n) < sent_frac
        hi[m] = 0xFFFFFFFF
        lo[m] = 0xFFFFFFFF
    half = n // 2
    h0, l0 = jax.lax.sort((jnp.asarray(hi[:half]), jnp.asarray(lo[:half])),
                          num_keys=2)
    h1, l1 = jax.lax.sort((jnp.asarray(hi[half:]), jnp.asarray(lo[half:])),
                          num_keys=2)
    ref = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    return (jnp.concatenate([h0, h1]), jnp.concatenate([l0, l1])), ref


@pytest.mark.parametrize("n", [2, 256, 1 << 12, 1 << 19])
@pytest.mark.parametrize("sent_frac", [0.0, 0.3])
def test_merge_matches_sort(n, sent_frac):
    (ch, cl), (rh, rl) = _sorted_halves(np.random.default_rng(n), n, sent_frac)
    mh, ml = bitonic.merge_sorted_halves(ch, cl)
    assert np.array_equal(np.asarray(mh), np.asarray(rh))
    assert np.array_equal(np.asarray(ml), np.asarray(rl))
    # the donated form agrees lane for lane
    dh, dl = bitonic.merge_sorted_halves_donated(jnp.array(ch), jnp.array(cl))
    assert np.array_equal(np.asarray(dh), np.asarray(rh))
    assert np.array_equal(np.asarray(dl), np.asarray(rl))


@pytest.mark.parametrize("log2n", [18, 19, 21])
def test_merge_cascade_xla(log2n):
    """The XLA stage cascade at the sizes the stream ladder's first
    carries reach, with sentinel tails, against lax.sort."""
    n = 1 << log2n
    (ch, cl), (rh, rl) = _sorted_halves(np.random.default_rng(log2n), n, 0.1)
    mh, ml = bitonic.merge_sorted_halves(ch, cl)
    assert np.array_equal(np.asarray(mh), np.asarray(rh))
    assert np.array_equal(np.asarray(ml), np.asarray(rl))


def test_merge_three_plane():
    """3-plane lex merge (key_hi, key_lo, lane_idx) at 2^18 lanes with
    many equal keys: the lane index breaks every tie."""
    n = 1 << 18
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 4, n, dtype=np.uint32)
    lo = rng.integers(0, 64, n, dtype=np.uint32)
    x = rng.permutation(n).astype(np.uint32)
    half = n // 2
    runs = [jax.lax.sort((jnp.asarray(hi[s]), jnp.asarray(lo[s]),
                          jnp.asarray(x[s])), num_keys=3)
            for s in (slice(0, half), slice(half, n))]
    cat = [jnp.concatenate([a, b]) for a, b in zip(*runs)]
    got = bitonic.merge_sorted_halves3(*cat)
    want = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(x)),
                        num_keys=3)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n", [1 << 10, 1 << 19])
def test_merge_single_plane(n):
    rng = np.random.default_rng(n)
    lo = rng.integers(0, 1 << 31, n, dtype=np.uint32)
    lo[rng.random(n) < 0.2] = 0xFFFFFFFF
    half = n // 2
    l0 = jax.lax.sort(jnp.asarray(lo[:half]))
    l1 = jax.lax.sort(jnp.asarray(lo[half:]))
    ref = jax.lax.sort(jnp.asarray(lo))
    cat = jnp.concatenate([l0, l1])
    out = bitonic.merge_sorted_halves1(cat)
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    # the donated form gives the same planes
    out_d = bitonic.merge_sorted_halves1_donated(jnp.array(cat))
    assert np.array_equal(np.asarray(out_d), np.asarray(ref))


@pytest.mark.parametrize("n_runs", [1, 2, 3, 5, 8])
def test_stream_ladder_folds_to_sorted(n_runs):
    """The shared StreamLadder (used by both engines) folds arbitrary
    run counts to the exact lax.sort order, sentinel padding included."""
    from kmer_tpu.table.stream_ladder import StreamLadder

    rng = np.random.default_rng(n_runs)
    m = 1 << 10
    ladder = StreamLadder(
        chunk=1 << 9,
        min_pad=1 << 6,
        sort_fn=lambda p: tuple(jax.lax.sort(p, num_keys=2)),
        merge_fn=lambda a, b: bitonic.merge_sorted_halves(
            *(jnp.concatenate([x, y]) for x, y in zip(a, b))
        ),
        pad_fn=lambda p, t: tuple(
            jnp.concatenate([x, jnp.full((t - x.shape[0],), 0xFFFFFFFF,
                                         jnp.uint32)]) if t != x.shape[0]
            else x
            for x in p
        ),
        concat_fn=lambda runs: tuple(
            jnp.concatenate([r[i] for r in runs]) for i in range(2)
        ),
        slice_fn=lambda p, a, b: tuple(x[a:b] for x in p),
        size_fn=lambda p: int(p[0].shape[0]),
    )
    all_hi, all_lo = [], []
    for _ in range(n_runs):
        hi = rng.integers(0, 1 << 30, m, dtype=np.uint32)
        lo = rng.integers(0, 1 << 32, m, dtype=np.uint32)
        ladder.add((jnp.asarray(hi), jnp.asarray(lo)))
        all_hi.append(hi)
        all_lo.append(lo)
    mh, ml = ladder.planes()
    pad = mh.shape[0] - n_runs * m
    cat_hi = np.concatenate(all_hi + [np.full(pad, 0xFFFFFFFF, np.uint32)])
    cat_lo = np.concatenate(all_lo + [np.full(pad, 0xFFFFFFFF, np.uint32)])
    rh, rl = jax.lax.sort((jnp.asarray(cat_hi), jnp.asarray(cat_lo)),
                          num_keys=2)
    assert np.array_equal(np.asarray(mh), np.asarray(rh))
    assert np.array_equal(np.asarray(ml), np.asarray(rl))
    # folding is lossless under further adds: every key survives
    ladder.add((jnp.asarray(all_hi[0]), jnp.asarray(all_lo[0])))
    mh2, ml2 = ladder.planes()
    assert mh2.shape[0] >= (n_runs + 1) * m
    packed = (np.asarray(mh2).astype(np.uint64) << np.uint64(32)
              ) | np.asarray(ml2).astype(np.uint64)
    want = np.concatenate([cat_hi.astype(np.uint64) << np.uint64(32)
                           | cat_lo.astype(np.uint64),
                           all_hi[0].astype(np.uint64) << np.uint64(32)
                           | all_lo[0].astype(np.uint64)])
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    assert np.array_equal(np.sort(packed[packed != sent]),
                          np.sort(want[want != sent]))


def test_stream_ladder_fold_does_not_compound():
    """Interleaved add/fold cycles must not grow resident plane size
    unboundedly (the fold is cache-only, never re-laddered)."""
    from kmer_tpu.table import compactor as C

    comp = C.KmerCompactor(stream_sorted=True)
    rng = np.random.default_rng(0)
    sizes = []
    for _ in range(6):
        lo = rng.integers(0, 1 << 32, 100, dtype=np.uint32)
        hi = rng.integers(0, 1 << 30, 100, dtype=np.uint32)
        comp.add_raw(jnp.asarray(hi), jnp.asarray(lo))
        comp.hist(256, None)  # forces a fold every cycle
        sizes.append(int(comp.stream.planes()[0].shape[0]))
    # 600 data lanes: every fold pads to the same 2^16 floor, no doubling
    assert max(sizes) == min(sizes) == C._STREAM_MIN
