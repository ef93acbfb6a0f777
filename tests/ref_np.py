"""Independent numpy/pure-Python oracle implementations of the reference
semantics (rolling canonical k-mer extraction, hash64, dict counting),
used to validate the device kernels.  Derived from the documented behavior
of /root/reference/kc-c1.c:31-49 and kc-c4.c:40-100."""

import numpy as np

NT4 = np.full(256, 4, np.uint8)
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    NT4[ord(ch)] = code
    NT4[ord(ch.lower())] = code


def hash64_np(key, mask):
    key = np.asarray(key, np.uint64)
    mask = np.uint64(mask)
    with np.errstate(over="ignore"):  # mod-2^64 wraparound is the point
        key = (~key + (key << np.uint64(21))) & mask
        key = key ^ key >> np.uint64(24)
        key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & mask
        key = key ^ key >> np.uint64(14)
        key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & mask
        key = key ^ key >> np.uint64(28)
        key = (key + (key << np.uint64(31))) & mask
    return key


def rolling_kmers(seq: bytes, k: int, do_hash=False):
    """Per-position canonical k-mers of one sequence, scalar rolling loop.

    k == 32 reproduces the reference's x86-64 behavior: the C mask
    expression `(1ULL << k*2) - 1` shifts by 64, which x86 computes
    mod 64, giving mask 0 — every canonical key is 0."""
    mask = 0 if k == 32 else (1 << (2 * k)) - 1
    shift = (k - 1) * 2
    x0 = x1 = 0
    l = 0
    out = []
    for i, b in enumerate(seq):
        c = int(NT4[b])
        if c < 4:
            x0 = ((x0 << 2) | c) & mask
            x1 = (x1 >> 2) | ((3 - c) << shift)
            l += 1
            if l >= k:
                y = min(x0, x1)
                if do_hash:
                    y = int(hash64_np(y, mask))
                out.append((i, y))
        else:
            l = 0
            x0 = x1 = 0
    return out


def count_kmers_dict(seqs, k: int, do_hash=False):
    """Exact dict-based canonical k-mer counts over a list of sequences."""
    h = {}
    for s in seqs:
        for _, y in rolling_kmers(s, k, do_hash):
            h[y] = h.get(y, 0) + 1
    return h


def hist_from_counts(counts, n_bins, saturate=None):
    """Histogram of count values: bin = min(count, n_bins-1); bins 1..n_bins-1.

    `saturate` caps the stored count first (kc-c2: 255, kc-c4/yak: 1023)."""
    hist = [0] * n_bins
    for c in counts:
        if saturate is not None:
            c = min(c, saturate)
        hist[min(c, n_bins - 1)] += 1
    return hist
