"""Myers bit-vector approximate matching — the edlib-equivalent kernel.

Implements the Hyyrö/Myers bit-parallel edit-distance scan in HW
(infix / semi-global) mode for patterns of length <= 31 (one uint32
word per pattern), exactly the edlib configuration ed-vaf-counter uses
(/root/reference/ed-vaf-counter.c:103: EDLIB_MODE_HW, EDLIB_TASK_LOC;
edlib core recurrence /root/reference/edlib.cpp:412).

Device mapping: the per-text-position recurrence is a lax.scan; the
(reads x patterns) plane is fully vectorized uint32 lanes — every read
lane advances every pattern's automaton in parallel, replacing edlib's
scalar word loop.  Per (read, pattern) we track the running best score
and the number of end positions achieving it, which equals edlib's
numLocations for optimal alignments (the reference's per-pair count,
ed-vaf-counter.c:108-118).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32


def build_peq(patterns_codes, pat_len, n_alpha: int = 4):
    """Peq bitmasks: (P, n_alpha) uint32; bit i set iff
    pattern[i] == letter.

    patterns_codes: (P, Lp) uint8 alphabet codes (>= n_alpha never
    matches).  n_alpha defaults to the 2-bit ACGT alphabet; ed-vaf-
    counter passes the distinct-pattern-byte alphabet instead so that
    matching is byte-exact like edlib's (no case folding, N == N).
    """
    P, Lp = patterns_codes.shape
    bit = (jnp.arange(Lp, dtype=U32))[None, :]
    masks = []
    for c in range(n_alpha):
        is_c = (patterns_codes == c) & (
            jnp.arange(Lp)[None, :] < pat_len[:, None]
        )
        masks.append(jnp.sum(jnp.where(is_c, U32(1) << bit, U32(0)), axis=1))
    return jnp.stack(masks, axis=1)  # (P, 4)


@partial(jax.jit, static_argnames=("max_e",))
def myers_hw_counts(peq, pat_len, reads_codes, read_len, max_e: int):
    """Counts of optimal end locations per (read, pattern).

    peq: (P, n_alpha) uint32, pat_len: (P,) int32
    reads_codes: (R, L) uint8, read_len: (R,) int32
    Returns (R, P) int32: numLocations if best distance <= max_e else 0.
    """
    P = peq.shape[0]
    R, L = reads_codes.shape
    m = pat_len.astype(U32)
    hibit = U32(1) << (m - 1)  # (P,)
    full = jnp.where(
        m >= 32, U32(0xFFFFFFFF), (U32(1) << m) - 1
    )

    pv0 = jnp.broadcast_to(full, (R, P))
    mv0 = jnp.zeros((R, P), U32)
    score0 = jnp.broadcast_to(pat_len.astype(I32), (R, P))
    best0 = jnp.full((R, P), 0x3FFFFFFF, I32)
    cnt0 = jnp.zeros((R, P), I32)

    peq_t = peq.T  # (4, P)

    def step(carry, inputs):
        pv, mv, score, best, cnt = carry
        c, valid = inputs  # c: (R,) uint8; valid: (R,) bool
        # Eq per (read, pattern): n_alpha-way select, no gather
        eq = jnp.zeros((R, P), U32)
        for base in range(peq_t.shape[0]):
            eq = jnp.where((c == base)[:, None], peq_t[base][None, :], eq)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        inc = ((ph & hibit[None, :]) != 0).astype(I32)
        dec = ((mh & hibit[None, :]) != 0).astype(I32)
        new_score = score + inc - dec
        ph2 = ph << 1
        mh2 = mh << 1
        new_pv = (mh2 | ~(xv | ph2)) & full[None, :]
        new_mv = ph2 & xv
        v = valid[:, None]
        pv = jnp.where(v, new_pv, pv)
        mv = jnp.where(v, new_mv, mv)
        score = jnp.where(v, new_score, score)
        better = v & (score < best)
        same = v & (score == best)
        cnt = jnp.where(better, 1, jnp.where(same, cnt + 1, cnt))
        best = jnp.where(better, score, best)
        return (pv, mv, score, best, cnt), None

    cs = reads_codes.T  # (L, R)
    valids = (
        jnp.arange(L, dtype=I32)[:, None] < read_len[None, :]
    )  # (L, R)
    (pv, mv, score, best, cnt), _ = jax.lax.scan(
        step, (pv0, mv0, score0, best0, cnt0), (cs, valids)
    )
    return jnp.where(best <= max_e, cnt, 0)


def build_peq_multiword(patterns_codes, pat_len, n_alpha: int, n_words: int):
    """Multi-word Peq bitmasks: (P, W, n_alpha) uint32; bit i%32 of
    word i//32 set iff pattern[i] == letter (edlib's buildPeq over
    W words, edlib.cpp:112, one uint32 lane per word here)."""
    P, Lp = patterns_codes.shape
    pos = jnp.arange(Lp)
    word = (pos // 32)[None, :]
    bit = (pos % 32).astype(U32)[None, :]
    in_pat = pos[None, :] < pat_len[:, None]
    masks = []
    for c in range(n_alpha):
        hot = jnp.where(
            (patterns_codes == c) & in_pat, U32(1) << bit, U32(0)
        )  # (P, Lp)
        per_word = [
            jnp.sum(jnp.where(word == w, hot, U32(0)), axis=1)
            for w in range(n_words)
        ]
        masks.append(jnp.stack(per_word, axis=1))  # (P, W)
    return jnp.stack(masks, axis=2)  # (P, W, n_alpha)


@partial(jax.jit, static_argnames=("max_e", "n_words"))
def myers_hw_counts_multiword(peq, pat_len, reads_codes, read_len,
                              max_e: int, n_words: int):
    """Multi-word variant of myers_hw_counts for patterns longer than
    32 bases: W uint32 words per (read, pattern) lane with ripple
    carries unrolled over the static word count, all inside one
    lax.scan over text positions (edlib's WORD_SIZE-block column loop,
    edlib.cpp:412, data-parallel over the (reads x patterns) plane).

    peq: (P, W, n_alpha) uint32 from build_peq_multiword
    pat_len: (P,) int32; reads_codes: (R, L) uint8; read_len: (R,) int32
    Returns (R, P) int32: numLocations if best distance <= max_e else 0.
    """
    W = n_words
    P = peq.shape[0]
    R, L = reads_codes.shape
    m = pat_len.astype(I32)
    hw_word = (m - 1) // 32          # (P,) word holding the top bit
    hb = ((m - 1) % 32).astype(U32)  # (P,) bit within that word
    # per-(pattern, word) occupancy mask: all pattern bits in word w
    wlo = jnp.arange(W, dtype=I32) * 32  # (W,)
    nbits = jnp.clip(m[:, None] - wlo[None, :], 0, 32)  # (P, W)
    mfull = jnp.where(
        nbits >= 32,
        U32(0xFFFFFFFF),
        (U32(1) << nbits.astype(U32)) - U32(1),
    )  # (P, W)

    pv0 = tuple(jnp.broadcast_to(mfull[:, w], (R, P)) for w in range(W))
    mv0 = tuple(jnp.zeros((R, P), U32) for _ in range(W))
    score0 = jnp.broadcast_to(m, (R, P))
    best0 = jnp.full((R, P), 0x3FFFFFFF, I32)
    cnt0 = jnp.zeros((R, P), I32)

    peq_wa = tuple(
        tuple(peq[:, w, a] for a in range(peq.shape[2])) for w in range(W)
    )  # [W][n_alpha] -> (P,)
    mfull_w = tuple(mfull[:, w][None, :] for w in range(W))  # (1, P) each

    def step(carry, inputs):
        pv, mv, score, best, cnt = carry
        c, valid = inputs  # c: (R,) uint8; valid: (R,) bool
        eq = []
        for w in range(W):
            e = jnp.zeros((R, P), U32)
            for base, col in enumerate(peq_wa[w]):
                e = jnp.where((c == base)[:, None], col[None, :], e)
            eq.append(e)
        xv = [eq[w] | mv[w] for w in range(W)]
        # ((eq & pv) + pv) with ripple carry across words, low -> high
        xh = []
        carry_u = jnp.zeros((R, P), U32)
        for w in range(W):
            a = eq[w] & pv[w]
            s1 = a + pv[w]
            c1 = s1 < a
            s = s1 + carry_u
            c2 = s < s1
            carry_u = (c1 | c2).astype(U32)
            xh.append((s ^ pv[w]) | eq[w])
        ph = [mv[w] | ~(xh[w] | pv[w]) for w in range(W)]
        mh = [pv[w] & xh[w] for w in range(W)]
        # score delta from the per-pattern top bit (word hw_word, bit hb)
        inc = jnp.zeros((R, P), I32)
        dec = jnp.zeros((R, P), I32)
        for w in range(W):
            sel = (hw_word == w)[None, :]
            inc = inc | jnp.where(
                sel, ((ph[w] >> hb[None, :]) & U32(1)).astype(I32), 0
            )
            dec = dec | jnp.where(
                sel, ((mh[w] >> hb[None, :]) & U32(1)).astype(I32), 0
            )
        new_score = score + inc - dec
        # shift left by one with cross-word carry (HW mode: bit 0 of
        # word 0 stays 0 — free start in the text)
        ph2 = [ph[0] << 1] + [
            (ph[w] << 1) | (ph[w - 1] >> 31) for w in range(1, W)
        ]
        mh2 = [mh[0] << 1] + [
            (mh[w] << 1) | (mh[w - 1] >> 31) for w in range(1, W)
        ]
        new_pv = [(mh2[w] | ~(xv[w] | ph2[w])) & mfull_w[w] for w in range(W)]
        new_mv = [ph2[w] & xv[w] for w in range(W)]
        v = valid[:, None]
        pv = tuple(jnp.where(v, new_pv[w], pv[w]) for w in range(W))
        mv = tuple(jnp.where(v, new_mv[w], mv[w]) for w in range(W))
        score = jnp.where(v, new_score, score)
        better = v & (score < best)
        same = v & (score == best)
        cnt = jnp.where(better, 1, jnp.where(same, cnt + 1, cnt))
        best = jnp.where(better, score, best)
        return (pv, mv, score, best, cnt), None

    cs = reads_codes.T  # (L, R)
    valids = jnp.arange(L, dtype=I32)[:, None] < read_len[None, :]
    (pv, mv, score, best, cnt), _ = jax.lax.scan(
        step, (pv0, mv0, score0, best0, cnt0), (cs, valids)
    )
    return jnp.where(best <= max_e, cnt, 0)


def hw_counts_long_pattern(pat_codes, reads_codes, read_len, max_e: int,
                           n_alpha: int = 4):
    """Host cross-check for patterns longer than 32 bases (the u32-lane
    kernel's word limit; edlib handles any length via multi-word
    vectors, edlib.cpp:412).  The same recurrence as myers_hw_counts
    over W = ceil(m/64) uint64 words with ripple carries, vectorized
    over reads with numpy — the per-text-position loop stays in Python
    but each step is a handful of (R,)-wide numpy ops.  The production
    long-pattern path is myers_hw_counts_multiword; this stays as the
    independent oracle for it (tests/test_myers.py).

    pat_codes: iterable of alphabet codes (>= n_alpha never matches).
    reads_codes: (R, L) uint8; read_len: (R,) lengths.
    Returns a list of R counts (numLocations if best <= max_e else 0).
    """
    import numpy as np

    m = len(pat_codes)
    W = (m + 63) // 64
    ONE = np.uint64(1)
    # peq per word: (W, n_alpha) uint64
    peq = np.zeros((W, n_alpha), np.uint64)
    for i, c in enumerate(pat_codes):
        if c < n_alpha:
            peq[i // 64, c] |= ONE << np.uint64(i % 64)
    last_bits = m - 64 * (W - 1)
    full_last = (
        np.uint64(0xFFFFFFFFFFFFFFFF)
        if last_bits == 64
        else (ONE << np.uint64(last_bits)) - ONE
    )
    hw, hb = (m - 1) // 64, np.uint64((m - 1) % 64)

    reads_codes = np.asarray(reads_codes, np.uint8)
    read_len = np.asarray(read_len, np.int64)
    R, L = reads_codes.shape
    pv = np.zeros((W, R), np.uint64)
    pv[:-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    pv[-1] = full_last
    mv = np.zeros((W, R), np.uint64)
    score = np.full(R, m, np.int64)
    best = np.full(R, 1 << 30, np.int64)
    cnt = np.zeros(R, np.int64)
    c63 = np.uint64(63)

    for t in range(int(read_len.max()) if R else 0):
        c = reads_codes[:, t]
        valid = t < read_len
        cc = np.minimum(c, n_alpha - 1)
        eq = np.where(c < n_alpha, peq[:, cc], np.uint64(0))  # (W, R)
        xv = eq | mv
        # (eq & pv) + pv with ripple carry across words
        xh = np.empty_like(pv)
        carry = np.zeros(R, np.uint64)
        for w in range(W):
            a = eq[w] & pv[w]
            s1 = a + pv[w]
            c1 = s1 < a
            s = s1 + carry
            c2 = s < s1
            carry = (c1 | c2).astype(np.uint64)
            xh[w] = (s ^ pv[w]) | eq[w]
        ph = mv | ~(xh | pv)
        mh = pv & xh
        inc = ((ph[hw] >> hb) & ONE).astype(np.int64)
        dec = ((mh[hw] >> hb) & ONE).astype(np.int64)
        new_score = score + inc - dec
        # shift left by one with cross-word carry (low bit of word 0 = 0,
        # as in the single-word kernel)
        ph2 = np.empty_like(ph)
        mh2 = np.empty_like(mh)
        ph2[0] = ph[0] << ONE
        mh2[0] = mh[0] << ONE
        for w in range(1, W):
            ph2[w] = (ph[w] << ONE) | (ph[w - 1] >> c63)
            mh2[w] = (mh[w] << ONE) | (mh[w - 1] >> c63)
        new_pv = mh2 | ~(xv | ph2)
        new_pv[-1] &= full_last
        new_mv = ph2 & xv
        v = valid
        pv = np.where(v, new_pv, pv)
        mv = np.where(v, new_mv, mv)
        score = np.where(v, new_score, score)
        better = v & (score < best)
        same = v & (score == best)
        cnt = np.where(better, 1, np.where(same, cnt + 1, cnt))
        best = np.where(better, score, best)
    return np.where(best <= max_e, cnt, 0).tolist()
