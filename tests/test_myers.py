"""Unit tests for the Myers bit-vector kernels (kmer_tpu.kernels.myers).

The multi-word device kernel is checked against two independent oracles:
the single-word kernel in their overlap range (m <= 32, where the two
share no word-handling code paths — one word vs ripple carries), and
the numpy uint64 host implementation for long patterns (itself pinned
byte-identical to reference edlib by tests/test_golden_vaf_tools.py::
test_ed_long_reads_and_patterns)."""

import numpy as np
import pytest

import jax.numpy as jnp

from kmer_tpu.kernels.myers import (
    build_peq,
    build_peq_multiword,
    hw_counts_long_pattern,
    myers_hw_counts,
    myers_hw_counts_multiword,
)


def _random_case(rng, n_pat, pat_lens, n_reads, read_max, n_alpha=4,
                 plant=True):
    P = n_pat
    lp = max(pat_lens)
    pc = np.full((P, lp), 255, np.uint8)
    plen = np.zeros(P, np.int32)
    for i in range(P):
        m = pat_lens[i % len(pat_lens)]
        pc[i, :m] = rng.integers(0, n_alpha, m)
        plen[i] = m
    lens = rng.integers(1, read_max + 1, n_reads).astype(np.int32)
    codes = np.full((n_reads, read_max), 255, np.uint8)
    for r in range(n_reads):
        codes[r, : lens[r]] = rng.integers(0, n_alpha, lens[r])
    if plant:
        # plant exact and 1-error pattern copies so best <= max_e hits
        for r in range(0, n_reads, 3):
            i = int(rng.integers(0, P))
            m = int(plen[i])
            if lens[r] <= m:
                continue
            at = int(rng.integers(0, lens[r] - m))
            codes[r, at : at + m] = pc[i, :m]
            if r % 2:
                j = at + int(rng.integers(0, m))
                codes[r, j] = (codes[r, j] + 1) % n_alpha
    return pc, plen, codes, lens


@pytest.mark.parametrize("max_e", [0, 1, 2])
def test_multiword_matches_singleword_short_patterns(max_e):
    rng = np.random.default_rng(11 + max_e)
    pc, plen, codes, lens = _random_case(
        rng, n_pat=16, pat_lens=[5, 13, 21, 31, 32], n_reads=48,
        read_max=200,
    )
    peq1 = build_peq(jnp.asarray(pc), jnp.asarray(plen))
    got1 = np.asarray(
        myers_hw_counts(peq1, jnp.asarray(plen), jnp.asarray(codes),
                        jnp.asarray(lens), max_e)
    )
    for W in (1, 2, 3):
        peqw = build_peq_multiword(jnp.asarray(pc), jnp.asarray(plen), 4, W)
        gotw = np.asarray(
            myers_hw_counts_multiword(
                peqw, jnp.asarray(plen), jnp.asarray(codes),
                jnp.asarray(lens), max_e, W,
            )
        )
        np.testing.assert_array_equal(gotw, got1)


@pytest.mark.parametrize("max_e", [0, 1, 3])
def test_multiword_matches_numpy_long_patterns(max_e):
    rng = np.random.default_rng(101 + max_e)
    pat_lens = [33, 41, 64, 65, 97, 150]
    pc, plen, codes, lens = _random_case(
        rng, n_pat=12, pat_lens=pat_lens, n_reads=40, read_max=400,
    )
    W = (max(pat_lens) + 31) // 32
    peqw = build_peq_multiword(jnp.asarray(pc), jnp.asarray(plen), 4, W)
    gotw = np.asarray(
        myers_hw_counts_multiword(
            peqw, jnp.asarray(plen), jnp.asarray(codes),
            jnp.asarray(lens), max_e, W,
        )
    )
    for i in range(pc.shape[0]):
        want = hw_counts_long_pattern(
            pc[i, : plen[i]].tolist(), codes, lens, max_e
        )
        np.testing.assert_array_equal(gotw[:, i], np.asarray(want), err_msg=f"pattern {i} (m={plen[i]})")


def test_multiword_zero_length_reads_and_padding_lanes():
    rng = np.random.default_rng(7)
    pc, plen, codes, lens = _random_case(
        rng, n_pat=4, pat_lens=[40], n_reads=8, read_max=100, plant=False,
    )
    lens[3] = 0  # flushed-but-unfilled row: must contribute 0
    W = 2
    peqw = build_peq_multiword(jnp.asarray(pc), jnp.asarray(plen), 4, W)
    got = np.asarray(
        myers_hw_counts_multiword(
            peqw, jnp.asarray(plen), jnp.asarray(codes),
            jnp.asarray(lens), 2, W,
        )
    )
    assert (got[3] == 0).all()
