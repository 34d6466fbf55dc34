"""Blockwise rank (occ) over the flat BWT buffer.

Equivalent query semantics to the reference's rope_rank2a/rle_rank2a
(rope.c:179-194, rle.c:134-191), re-designed for a device: a dense per-block
prefix-count table plus a vectorized in-block count, instead of a B+-tree
descent plus run decoding.  All queries are batched.
"""

import jax
import jax.numpy as jnp

from ..alphabet import NSYM
from .scan import cumsum_blocked


def build_block_tables(bwt, K: int, dtype=jnp.int64):
    """Per-symbol prefix counts at every K-block boundary.

    bwt: int8[ALLOC] (content beyond n unspecified — rows past the live
    prefix are garbage and must never be consumed).  Returns
    dtype[ALLOC//K + 1, 6]; pass int32 while counts fit."""
    nb = bwt.shape[0] // K
    blocks = bwt.reshape(nb, K)
    sym = jnp.arange(NSYM, dtype=bwt.dtype)
    cnts = (blocks[:, :, None] == sym[None, None, :]).sum(
        axis=1, dtype=jnp.int32
    )
    pref = jnp.concatenate(
        [
            jnp.zeros((1, NSYM), dtype=dtype),
            cumsum_blocked(cnts.astype(dtype)),
        ]
    )
    return pref


def rank_global(bwt, blk_prefix, pos, K: int):
    """Batched 6-symbol rank at global positions.

    pos: int[Q] with 0 <= pos <= n.  Returns out[q, s] = |{ i < pos[q] :
    bwt[i] == s }| in blk_prefix's dtype (int32 tables while counts fit)."""
    blk = pos // K
    within = (pos % K).astype(jnp.int32)
    base = blk_prefix[blk]  # (Q, 6)
    blkdata = bwt.reshape(-1, K)[jnp.clip(blk, 0, bwt.shape[0] // K - 1)]
    j = jnp.arange(K, dtype=jnp.int32)
    inmask = j[None, :] < within[:, None]  # (Q, K)
    sym = jnp.arange(NSYM, dtype=bwt.dtype)
    eq = blkdata[:, :, None] == sym[None, None, :]  # (Q, K, 6)
    inc = (eq & inmask[:, :, None]).sum(axis=1, dtype=jnp.int32)
    return base + inc.astype(blk_prefix.dtype)


def rank2_global(bwt, blk_prefix, gl, gu, K: int):
    """Fused two-point rank for NARROW intervals: (occ_l, occ_u) with the
    PRECONDITION 0 <= gu - gl <= K for every query (then gu's block is
    gl's block or the one after, so ONE paired-row gather serves both
    ends).  This is the fast path for the BCR U-end rank: interval widths
    collapse below K within a few rounds, and two full rank calls would
    pay the (locality-bound) block gather twice (rope_rank2a's bidirectional
    single-descent two-point rank is the reference analogue, rle.c:134)."""
    blk = gl // K
    nb = bwt.shape[0] // K
    blkc = jnp.clip(blk, 0, nb - 2)
    # paired row gather: two (Q, K) rows by plain row indexing
    pair = bwt.reshape(-1, K)[
        blkc[:, None] + jnp.arange(2, dtype=blkc.dtype)[None, :]
    ].reshape(-1, 2 * K)
    j = jnp.arange(2 * K, dtype=jnp.int32)
    wl = (gl - blkc * K).astype(jnp.int32)  # gl's offset within the pair
    wu = (gu - blkc * K).astype(jnp.int32)
    sym = jnp.arange(NSYM, dtype=bwt.dtype)
    eq = pair[:, :, None] == sym[None, None, :]  # (Q, 2K, 6)
    ml = (j[None, :] < wl[:, None])[:, :, None]
    mu = (j[None, :] < wu[:, None])[:, :, None]
    # base is the prefix at blkc*K: exact for both ends since wl, wu are
    # within the pair (wu <= wl + K <= 2K by the precondition)
    basec = blk_prefix[blkc]
    inc_l = (eq & ml).sum(axis=1, dtype=jnp.int32)
    inc_u = (eq & mu).sum(axis=1, dtype=jnp.int32)
    occ_l = basec + inc_l.astype(blk_prefix.dtype)
    occ_u = basec + inc_u.astype(blk_prefix.dtype)
    return occ_l, occ_u
