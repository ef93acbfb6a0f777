"""Base encoding: ASCII nucleotides -> 2-bit codes, as pure VPU arithmetic.

Replicates the seq_nt4_table mapping of the reference
(/root/reference/kc-c1.c:12-29): A/a->0, C/c->1, G/g->2, T/t/U/u->3,
everything else -> 4 (invalid; resets the rolling k-mer window).

Instead of a 256-entry LUT gather, we use the classic arithmetic trick:
g = (ascii >> 1) & 3 maps A->0 C->1 G->3 T->2, and the gray-code
transform g ^ (g >> 1) fixes the order to A0 C1 G2 T3.  This is the
data-parallel analog of the reference's SSSE3 PSHUFB encoder
(/root/reference/vaf-counter.c:261-291) — a handful of elementwise ops
instead of a table lookup.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy copy of the mapping for host-side golden checks / host packing.
SEQ_NT4_NP = np.full(256, 4, np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    SEQ_NT4_NP[ord(_ch)] = _code
    SEQ_NT4_NP[ord(_ch.lower())] = _code


def encode_bases(ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """Map ASCII bytes (uint8) to 2-bit codes; invalid bases become 4.

    Returns uint8 array of the same shape with values in {0,1,2,3,4}.
    """
    x = ascii_u8.astype(jnp.uint8)
    upper = x & jnp.uint8(0xDF)  # fold a-z onto A-Z
    valid = (
        (upper == jnp.uint8(ord("A")))
        | (upper == jnp.uint8(ord("C")))
        | (upper == jnp.uint8(ord("G")))
        | (upper == jnp.uint8(ord("T")))
        | (upper == jnp.uint8(ord("U")))
    )
    g = (x >> 1) & jnp.uint8(3)
    code = g ^ (g >> 1)
    return jnp.where(valid, code, jnp.uint8(4))
