"""Flat-tier merge fused with the rank-table counts: one Pallas kernel for
the GPU (Triton route).

Gather form of index/merge.py's apply_insertions: output position p holds
the inserted symbol when p is an insertion destination (dest = pos +
stream), and otherwise the old symbol at p - #(destinations < p).  With
the destinations sorted (dest is strictly increasing in the tie rank, so
one M-wide scatter by stream sorts them), every output tile needs only
the destinations inside it:

* XLA sorts the destinations and finds each tile's first one with a
  searchsorted at the tile edges;
* one program per TILE-symbol output tile walks its own destinations,
  counting for each position those below it and picking up the inserted
  symbol, gathers the old symbols, and writes the tile together with the
  six per-K-block symbol counts of it;
* XLA prefix-sums the counts into the rank table (build_block_tables'
  second half).

Tiles at or past the new live prefix are skipped: their bytes and table
rows are unspecified, which every consumer allows (index/flat.py).  The
plain version walks the whole allocation several times (a mark scatter,
an exact cumsum, two scatters and the table rebuild); this reads the
live prefix once and writes it once.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..alphabet import NSYM
from .scan import cumsum_blocked

I32 = jnp.int32
TILE = 2048  # output symbols per program


def merge_kernel_applies(alloc: int, K: int) -> bool:
    """The kernel runs on the GPU when int32 positions cover the whole
    allocation and K-blocks tile the output tile."""
    return (
        jax.default_backend() == "gpu"
        and alloc + TILE < (1 << 31)
        and K & (K - 1) == 0
        and TILE % K == 0
    )


def _merge_tile(sd_ref, ss_ref, lo_ref, live_ref, old_ref, out_ref, cnt_ref,
                *, K, alloc):
    t = pl.program_id(0)
    R = TILE // K
    start = t * TILE

    @pl.when(start < live_ref[0])
    def _():
        row = jax.lax.broadcasted_iota(I32, (R, K), 0)
        p = start + row * K + jax.lax.broadcasted_iota(I32, (R, K), 1)

        def visit(j, carry):  # destination j of this tile
            below, ins = carry
            d = sd_ref[j]
            below = below + (d < p).astype(I32)
            ins = jnp.where(d == p, ss_ref[j], ins)
            return below, ins

        lo = lo_ref[t]
        below, ins = jax.lax.fori_loop(
            lo, lo_ref[t + 1], visit,
            (jnp.zeros((R, K), I32), jnp.full((R, K), -1, I32)),
        )
        src = jnp.clip(p - lo - below, 0, alloc - 1)
        old = old_ref[src].astype(I32)
        out = jnp.where(ins >= 0, ins, old)
        plgpu.store(out_ref.at[p], out.astype(jnp.int8), mask=p < alloc)
        blk = t * R + jax.lax.broadcasted_iota(I32, (R,), 0)
        nblk = alloc // K
        for s in range(NSYM):
            c = jnp.sum((out == s).astype(I32), axis=1, dtype=I32)
            plgpu.store(cnt_ref.at[s * nblk + blk], c, mask=blk < nblk)


@functools.partial(jax.jit, static_argnames=("K", "dtype", "interpret"))
def merge_flat(bwt, n, pos, sym, stream, valid, *, K, dtype,
               interpret=False):
    """apply_insertions + build_block_tables in one pass over the live
    prefix.  Same contract as apply_insertions (pos non-decreasing in
    stream, stream unique in [0, A) over valid rows); ``n`` None means
    the whole allocation is live.  Returns (bwt, blk_prefix)."""
    alloc = bwt.shape[0]
    m = pos.shape[0]
    slot = jnp.where(valid, stream, m).astype(I32)
    sd = jnp.full((m,), jnp.iinfo(I32).max, I32).at[slot].set(
        (pos + stream).astype(I32), mode="drop", unique_indices=True
    )
    ss = jnp.zeros((m,), I32).at[slot].set(
        sym.astype(I32), mode="drop", unique_indices=True
    )
    ntiles = -(-alloc // TILE)
    edges = jnp.arange(ntiles + 1, dtype=I32) * TILE
    lo = jnp.searchsorted(sd, edges, side="left").astype(I32)
    if n is None:
        live = jnp.asarray(alloc, I32)
    else:
        live = jnp.minimum(n + jnp.sum(valid, dtype=n.dtype), alloc)
    nblk = alloc // K
    out, cnts = pl.pallas_call(
        functools.partial(_merge_tile, K=K, alloc=alloc),
        out_shape=(
            jax.ShapeDtypeStruct((alloc,), jnp.int8),
            jax.ShapeDtypeStruct((NSYM * nblk,), I32),
        ),
        grid=(ntiles,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="merge_flat",
    )(sd, ss, lo, live.astype(I32).reshape(1), bwt)
    rows = cnts.reshape(NSYM, nblk).T.astype(dtype)
    table = jnp.concatenate(
        [jnp.zeros((1, NSYM), dtype), cumsum_blocked(rows)]
    )
    return out, table
