"""Coalesced batched insertion into the flat BWT buffer.

The device replacement for the reference's per-symbol rope/rle insertion
(rope_insert_run -> rle_insert_cached, rope.c:114-148, rle.c:10-97): a whole
round's insertions are applied in ONE vectorized pass instead of one tree
descent per run.

Contract: insertions are given per-string as (pos, sym, stream) where ``pos``
is the insertion point in OLD (start-of-round) coordinates and ``stream`` is
the tie-break rank among this round's insertions (0..A-1, consistent with
non-decreasing pos).  New position of insertion i is pos[i] + stream[i]; old
element j moves to j + |{i : pos[i] <= j}|.
"""

import jax.numpy as jnp

from .flat import PAD
from .scan import cumsum_blocked


def apply_insertions(bwt, n, pos, sym, stream, valid):
    """Return the new flat buffer with all valid insertions applied.

    bwt:    int8[CAP], content in [0, n); beyond n the content is
            UNSPECIFIED (PAD on this path, garbage after a Pallas merge
            round) and must never be consumed.
    pos:    int64[M] old-coordinate global insertion points (<= n), any order.
    sym:    int32[M] inserted symbols.
    stream: int64[M] global tie ranks (each in [0, A)), unique over valid.
    valid:  bool[M].
    """
    cap = bwt.shape[0]
    pdt = pos.dtype
    trash = jnp.asarray(cap, pdt)  # scatter target for masked lanes

    # mark[j] = number of insertions at old position j
    mark = jnp.zeros((cap,), dtype=jnp.int32)
    mark = mark.at[jnp.where(valid, pos, trash)].add(1, mode="drop")
    # exact=True: a single position can receive up to A insertions (e.g.
    # duplicate reads), overflowing the f32 window-sum fast path
    shift = cumsum_blocked(mark, exact=True)

    idx = jnp.arange(cap, dtype=pdt)
    dest_old = idx + shift  # old element j -> j + shift[j]
    new = jnp.full((cap,), PAD, dtype=bwt.dtype)
    # elements at j >= n (unspecified content) land at j + A >= n + A,
    # beyond the new live prefix: harmless, consumers never read there.
    new = new.at[dest_old].set(bwt, mode="drop")
    ins_dest = jnp.where(valid, pos + stream, trash)
    new = new.at[ins_dest].set(sym.astype(bwt.dtype), mode="drop")
    return new
