"""Extraction step (encode -> canonical window -> hash64 -> sentinel)
against the independent scalar oracle in tests/ref_np.py, and the
uniform-read rows fast path against the flat path."""

import numpy as np
import pytest

import jax.numpy as jnp

from ref_np import rolling_kmers

RNG = np.random.default_rng(23)
SENT = 0xFFFFFFFF


def _dirty_block(n, rng):
    return rng.choice(
        np.frombuffer(b"ACGTNacgt\x00x", np.uint8), size=n,
        p=[0.22, 0.22, 0.22, 0.22, 0.02, 0.02, 0.02, 0.02, 0.01, 0.02, 0.01],
    )


@pytest.mark.parametrize("k", [1, 15, 21, 31, 32])
def test_extract_step_matches_ref_np(k):
    """Every lane of the device step equals the scalar rolling loop's
    hashed canonical k-mer at that position (or the sentinel where no
    window ends).  At k = 32 the reference's shift semantics collapse
    every key to one value (kernels/kmer.py), so only its validity and
    constancy are compared."""
    from kmer_tpu.pipeline.counter import _extract_step

    block = _dirty_block(4099, np.random.default_rng(k))
    hi, lo, nk = _extract_step(jnp.asarray(block), k)
    keys = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo).astype(np.uint64)
    want = rolling_kmers(block.tobytes(), k, do_hash=True)
    pos = np.array([i for i, _ in want], np.int64)
    valid = np.zeros(len(block), bool)
    valid[pos] = True
    assert int(nk) == len(want)
    assert (keys[~valid] == np.uint64(0xFFFFFFFFFFFFFFFF)).all()
    if k < 32:
        vals = np.array([y for _, y in want], np.uint64)
        assert np.array_equal(keys[pos], vals)
    else:
        assert len(np.unique(keys[pos])) == 1


@pytest.mark.parametrize("k", [5, 21, 31])
def test_extract_rows_matches_flat(k):
    """The uniform-read rows fast path must yield exactly the valid-lane
    multiset of the flat path (it only removes lanes that are invalid by
    layout)."""
    from kmer_tpu.pipeline.counter import _extract_step, _extract_step_rows

    L = 151
    n_rows = 400
    rng = np.random.default_rng(7)
    buf = np.zeros(1 << 16, np.uint8)
    reads = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(n_rows, L),
                       p=[0.24, 0.24, 0.24, 0.24, 0.04])
    flat = np.zeros((n_rows, L + 1), np.uint8)
    flat[:, :L] = reads
    packed = flat.reshape(-1)
    buf[: packed.size] = packed

    fhi, flo, fnk = _extract_step(jnp.asarray(buf), k)
    rhi, rlo, rnk = _extract_step_rows(jnp.asarray(buf), k, L + 1)
    assert int(fnk) == int(rnk)

    def multiset(hi, lo):
        hi = np.asarray(hi).astype(np.uint64)
        lo = np.asarray(lo).astype(np.uint64)
        keys = (hi << np.uint64(32)) | lo
        keys = keys[keys != np.uint64(0xFFFFFFFFFFFFFFFF)]
        return np.sort(keys)

    assert np.array_equal(multiset(fhi, flo), multiset(rhi, rlo))
