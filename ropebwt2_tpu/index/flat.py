"""Flat, array-packed BWT state — the device replacement for the six
pointer-based B+-trees of the reference (rope.c/mrope.c).

The whole BWT lives in ONE device buffer of capacity CAP, as the concatenation
of the six next-symbol partitions B_0..B_5 (the partition invariant of
mrope.h:10-14: partition b = B[C(b)..C(b+1))).  Alongside it:

* ``psize``    int64[6]    current partition sizes (offsets = exclusive cumsum)
* ``pcounts``  int64[6,6]  per-partition per-symbol counts (the reference's
                           rope->c[6] for each rope)
* ``blk_prefix`` int[NB+1,6] per-symbol counts at every K-symbol block
                           boundary of the flat buffer — the rank index
                           (device-resident analogue of rld0's frame index,
                           rld0.c:163-205).  int32 while cap < 2^31,
                           int64 beyond.
* ``n``        int64       total symbols

Content beyond ``n`` is unspecified (PAD after the plain merge, stale
bytes after the GPU merge kernel) and must never be read: every consumer
bounds reads to pos <= n, and block-table prefixes only accumulate upward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import NSYM

PAD = 6  # fill value for fresh capacity; outside the 6-symbol alphabet


def table_dtype(cap: int):
    """blk_prefix dtype rule: int32 while every count fits."""
    return jnp.int32 if cap < (1 << 31) else jnp.int64


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatBwt:
    bwt: jax.Array  # int8[CAP]
    n: jax.Array  # int64 scalar
    psize: jax.Array  # int64[6]
    pcounts: jax.Array  # int64[6,6]
    blk_prefix: jax.Array  # int[NB_alloc+1, 6] (int32 while cap < 2^31)

    @property
    def cap(self) -> int:
        return self.bwt.shape[0]


def empty_state(cap: int, K: int) -> FlatBwt:
    from .rank import build_block_tables

    assert cap % K == 0
    bwt = jnp.full((cap,), PAD, dtype=jnp.int8)
    return FlatBwt(
        bwt=bwt,
        n=jnp.zeros((), dtype=jnp.int64),
        psize=jnp.zeros((NSYM,), dtype=jnp.int64),
        pcounts=jnp.zeros((NSYM, NSYM), dtype=jnp.int64),
        blk_prefix=jnp.zeros(
            (cap // K + 1, NSYM), dtype=table_dtype(cap)
        ),
    )


import functools


@functools.partial(jax.jit, static_argnames=("old_cap", "new_cap", "K"),
                   donate_argnums=(0, 1))
def _grow_arrays(bwt, blk_prefix, *, old_cap, new_cap, K):
    new_bwt = jnp.concatenate(
        [
            bwt[:old_cap],
            jnp.full((new_cap - old_cap,), PAD, dtype=jnp.int8),
        ]
    )
    tdt = table_dtype(new_cap)
    old_rows = old_cap // K + 1  # rows covering [0, old_cap]
    kept = blk_prefix[:old_rows].astype(tdt)
    boundary = kept[old_rows - 1 : old_rows]
    extra = new_cap // K + 1 - old_rows
    new_blk = jnp.concatenate(
        [kept, jnp.broadcast_to(boundary, (extra, NSYM))]
    )
    return new_bwt, new_blk


def grow_state(state: FlatBwt, new_cap: int, K: int) -> FlatBwt:
    """Re-plan to a larger capacity (host-side, between batches).

    The appended region is PAD (zero counts), so the rank table EXTENDS by
    repeating its row at the old-capacity boundary instead of recounting
    the whole buffer — a full rebuild materializes a (cap, 6) bool
    intermediate (25 GB at 4 Gsym) and is the only O(cap) compare pass the
    engine would otherwise pay between batches.  Rows of the old table
    beyond the live prefix may hold garbage (GPU merge kernel contract);
    the repeated row propagates that garbage only to rows past n, which no
    consumer reads.

    One jitted call with donated inputs, so the old buffers are reused."""
    assert new_cap % K == 0 and new_cap >= state.cap
    if new_cap == state.cap:
        return state
    bwt, blk_prefix = _grow_arrays(
        state.bwt, state.blk_prefix,
        old_cap=state.cap, new_cap=new_cap, K=K,
    )
    return FlatBwt(
        bwt=bwt,
        n=state.n,
        psize=state.psize,
        pcounts=state.pcounts,
        blk_prefix=blk_prefix,
    )


def state_from_partition_runs(partition_runs, K: int, cap: int = None):
    """Build device state from six per-partition run lists
    [(symbol, length), ...] — the FMR restore path (-i incremental)."""
    from .rank import build_block_tables

    parts = []
    psize = np.zeros(NSYM, dtype=np.int64)
    pcounts = np.zeros((NSYM, NSYM), dtype=np.int64)
    for b in range(NSYM):
        segs = [
            np.full(int(ln), c, dtype=np.int8) for c, ln in partition_runs[b]
        ]
        part = (
            np.concatenate(segs) if segs else np.zeros((0,), dtype=np.int8)
        )
        parts.append(part)
        psize[b] = part.shape[0]
        for c, ln in partition_runs[b]:
            pcounts[b, c] += int(ln)
    flat = np.concatenate(parts) if parts else np.zeros((0,), np.int8)
    n = flat.shape[0]
    if cap is None:
        cap = max(K, -(-n // K) * K)
    assert cap % K == 0 and cap >= n
    buf = np.full(cap, PAD, dtype=np.int8)
    buf[:n] = flat
    bwt = jnp.asarray(buf)
    return FlatBwt(
        bwt=bwt,
        n=jnp.asarray(n, dtype=jnp.int64),
        psize=jnp.asarray(psize),
        pcounts=jnp.asarray(pcounts),
        blk_prefix=build_block_tables(bwt, K, dtype=table_dtype(cap)),
    )
