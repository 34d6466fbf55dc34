"""4-bit packed BWT storage (2 symbols/byte) — the capacity mode.

The reference holds 122 Gbp in 34 GB RAM because its index is run-length
compressed (rle.h:39-75, README.md:36-39).  The flat buffer spends 1
byte/symbol plus the merge's double buffer; nibble packing halves both the
resident footprint and the device-memory traffic of every rank gather and
merge.

Packing layout — VERTICAL PLANE PAIRS at 128-symbol row granularity:

    packed[r, j] = sym[(2r) * 128 + j]  |  sym[(2r+1) * 128 + j] << 4

i.e. the low nibbles of packed row r are symbol row 2r and the high
nibbles are symbol row 2r+1.  A SYMBOL ROW stays a complete 128-wide
vector in one nibble plane, so rank's in-block counts apply per plane
unchanged and extracting a row costs one shift+mask.

Rank tables in capacity mode are TWO-LEVEL (the device analogue of rld0's
superblock frame, rld0.c:163-205): an int64 anchor row per 2^24 symbols
plus int32 per-K-block counts relative to the anchor, so the wide table
stays int32 at any capacity.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import NSYM
from .flat import PAD
from .scan import cumsum_blocked

LANE = 128
ACHUNK = 1 << 24  # symbols per int64 anchor row
I32 = jnp.int32
I64 = jnp.int64


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PackedFlatBwt:
    """Capacity-mode state: 4-bit packed buffer + two-level rank tables.
    Drop-in sibling of flat.FlatBwt (same n/psize/pcounts bookkeeping);
    the engine branches on the state type at trace time."""

    pbwt: jax.Array  # uint8[cap//2]
    n: jax.Array  # int64 scalar
    psize: jax.Array  # int64[6]
    pcounts: jax.Array  # int64[6,6]
    blkA: jax.Array  # int64[(cap >> 24) + 2, 6] anchor rows
    blkB: jax.Array  # int32[cap//128 + 1, 6] anchor-relative rows

    @property
    def cap(self) -> int:
        return self.pbwt.shape[0] * 2


PACKED_PAD_BYTE = np.uint8(PAD | (PAD << 4))


def empty_packed_state(cap: int) -> PackedFlatBwt:
    assert cap % 256 == 0
    na = (cap + ACHUNK - 1) // ACHUNK
    return PackedFlatBwt(
        pbwt=jnp.full((cap // 2,), PACKED_PAD_BYTE, dtype=jnp.uint8),
        n=jnp.zeros((), I64),
        psize=jnp.zeros((NSYM,), I64),
        pcounts=jnp.zeros((NSYM, NSYM), I64),
        blkA=jnp.zeros((na + 1, NSYM), I64),
        # plane-separated layout: lo rows [0, N] + hi rows [N+1, 2N+1]
        blkB=jnp.zeros((2 * (cap // 256) + 2, NSYM), I32),
    )


@functools.partial(jax.jit, static_argnames=("old_cap", "new_cap"),
                   donate_argnums=(0, 1, 2))
def _grow_packed_arrays(pbwt, blkA, blkB, *, old_cap, new_cap):
    """Extend the packed allocation and its tables.  Every appended table
    row corresponds to a position >= old_cap >= n, which no consumer reads
    (the flat.py garbage contract), and the next merge rebuilds both
    levels from streamed counts — so the extension rows just repeat the
    boundary values."""
    new_p = jnp.concatenate([
        pbwt[: old_cap // 2],
        jnp.full((new_cap // 2 - old_cap // 2,), PACKED_PAD_BYTE, jnp.uint8),
    ])
    # plane-separated blkB: extend each plane block, repeating the
    # boundary row (extension rows are all past n: garbage-tolerated)
    n_old = old_cap // 256
    n_new = new_cap // 256
    lo_old = blkB[: n_old + 1]
    hi_old = blkB[n_old + 1 :]
    b_bound = lo_old[n_old : n_old + 1]
    new_B = jnp.concatenate([
        lo_old,
        jnp.broadcast_to(b_bound, (n_new - n_old, NSYM)),
        hi_old[:n_old],
        jnp.broadcast_to(b_bound, (n_new + 1 - n_old, NSYM)),
    ])
    na_new = (new_cap + ACHUNK - 1) // ACHUNK
    old_na = blkA.shape[0]
    a_bound = blkA[old_na - 1 : old_na]
    if na_new + 1 > old_na:
        new_A = jnp.concatenate([
            blkA, jnp.broadcast_to(a_bound, (na_new + 1 - old_na, NSYM))
        ])
    else:
        new_A = blkA[: na_new + 1]
    return new_p, new_A, new_B


def grow_packed_state(state: PackedFlatBwt, new_cap: int) -> PackedFlatBwt:
    assert new_cap % 256 == 0 and new_cap >= state.cap
    if new_cap == state.cap:
        return state
    pbwt, blkA, blkB = _grow_packed_arrays(
        state.pbwt, state.blkA, state.blkB,
        old_cap=state.cap, new_cap=new_cap,
    )
    return PackedFlatBwt(pbwt=pbwt, n=state.n, psize=state.psize,
                         pcounts=state.pcounts, blkA=blkA, blkB=blkB)


@functools.partial(jax.jit, static_argnames=("cap",), donate_argnums=(0,))
def _pack_from_int8(bwt_alloc, *, cap):
    # bytes past the live prefix are unspecified: PAD keeps them a nibble
    body = bwt_alloc[:cap]
    body = jnp.where((body < 0) | (body > 6), 6, body)
    return pack_bwt(body)


def packed_from_flat(state, new_cap: int) -> PackedFlatBwt:
    """Convert an int8 FlatBwt into capacity mode at ``new_cap`` (>= the
    old capacity): pack the buffer, then grow; tables are rebuilt once."""
    assert new_cap % 256 == 0 and new_cap >= state.cap
    pbwt = _pack_from_int8(state.bwt, cap=state.cap)
    blkA, blkB = build_two_level_tables(pbwt, state.cap)
    st = PackedFlatBwt(pbwt=pbwt, n=state.n, psize=state.psize,
                       pcounts=state.pcounts, blkA=blkA, blkB=blkB)
    return grow_packed_state(st, new_cap)


def pack_bwt(sym_flat):
    """int8[N] symbols (N % 256 == 0) -> uint8[N//2] vertical-pair bytes."""
    rows = sym_flat.reshape(-1, 2, LANE).astype(jnp.uint8)
    return (rows[:, 0, :] | (rows[:, 1, :] << 4)).reshape(-1)


def unpack_bwt(packed_flat):
    """uint8[N//2] -> int8[N] symbols (inverse of pack_bwt)."""
    p = packed_flat.reshape(-1, LANE)
    lo = (p & 0xF).astype(jnp.int8)
    hi = (p >> 4).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=1).reshape(-1)


def pack_bwt_np(sym_flat):
    rows = sym_flat.reshape(-1, 2, LANE).astype(np.uint8)
    return (rows[:, 0, :] | (rows[:, 1, :] << 4)).reshape(-1)


def unpack_bwt_np(packed_flat):
    p = packed_flat.reshape(-1, LANE)
    out = np.empty((p.shape[0], 2, LANE), np.int8)
    out[:, 0, :] = p & 0xF
    out[:, 1, :] = p >> 4
    return out.reshape(-1)


def build_two_level_tables(packed_flat, cap):
    """(blkA, blkB) for K = 128 in the PLANE-SEPARATED blkB layout (see
    tables_from_plane_counts).  Built in 6 single-symbol passes with no
    symbol-row interleave."""
    p = packed_flat[: cap // 2].reshape(-1, LANE)
    plo = (p & 0xF).astype(jnp.int8)
    phi = (p >> 4).astype(jnp.int8)
    lo6 = jnp.stack(
        [(plo == s).sum(axis=1, dtype=I32) for s in range(NSYM)], axis=1
    )
    hi6 = jnp.stack(
        [(phi == s).sum(axis=1, dtype=I32) for s in range(NSYM)], axis=1
    )
    return tables_from_plane_counts(lo6, hi6, cap)


def blkb_row(blk, nprows):
    """blkB row index for symbol-row ``blk`` in the plane-separated layout:
    lo-plane prefixes occupy rows [0, N], hi-plane rows [N+1, 2N+1]
    (N = nprows = cap // 256)."""
    return (blk >> 1) + (blk & 1) * (nprows + 1)


def tables_from_plane_counts(lo6, hi6, cap):
    """Two-level tables from per-PACKED-row per-plane symbol counts (each
    int32 (cap//256, 6)).

    blkB layout is PLANE-SEPARATED - row u holds the prefix at symbol row
    2u, row (N+1)+u the prefix at 2u+1 - so no symbol-row interleave is
    ever materialized.  Consumers index rows with blkb_row().

    All wide arrays stay int32: the global prefix may WRAP past 2^31, but
    the anchor-relative rows are < 2^24, so modular subtraction recovers
    them exactly; only the (na+1, 6) anchor level accumulates in int64."""
    from .scan import cumsum_small

    nprows = cap // (2 * LANE)  # packed rows
    rpc = ACHUNK // (2 * LANE)  # packed rows per anchor chunk
    S = (lo6 + hi6).astype(I32)
    incl = cumsum_blocked(S)  # per-pair inclusive prefix, mod 2^32
    PS = jnp.concatenate([jnp.zeros((1, NSYM), I32), incl])  # (N+1, 6)
    na = (cap + ACHUNK - 1) // ACHUNK
    bnd = jnp.minimum(jnp.arange(na + 1, dtype=I32) * rpc, nprows)
    bnd32 = PS[bnd]  # (na+1, 6) chunk-boundary prefixes (mod 2^32)
    tots = (bnd32[1:] - bnd32[:-1]).astype(I64)
    anchors = jnp.concatenate(
        [jnp.zeros((1, NSYM), I64), cumsum_small(tots, axis=0)]
    )
    arow = jnp.minimum(jnp.arange(nprows + 1, dtype=I32) // rpc, na)
    rel_lo = PS - bnd32[arow]  # modular; true value < 2^24
    rel_hi = rel_lo + jnp.concatenate(
        [lo6.astype(I32), jnp.zeros((1, NSYM), I32)]
    )
    blkB = jnp.concatenate([rel_lo, rel_hi])  # (2N+2, 6)
    return anchors, blkB


def rank_global_packed(pbwt, blkA, blkB, pos, K=LANE):
    """Batched 6-symbol rank over the packed buffer with two-level tables.
    K is fixed at 128 (one table row per symbol row).  pos: int[Q],
    0 <= pos <= n.  Returns (Q, 6) int64."""
    assert K == LANE
    blk = (pos // LANE).astype(I32)  # symbol row
    within = (pos % LANE).astype(I32)
    nprows = blkB.shape[0] // 2 - 1  # plane-separated layout (blkb_row)
    base = blkA[(pos // ACHUNK).astype(I32)] + blkB[
        blkb_row(blk, nprows)
    ].astype(I64)
    prow = blk >> 1
    nrp = pbwt.shape[0] // LANE
    rows = pbwt.reshape(-1, LANE)[jnp.clip(prow, 0, nrp - 1)]  # (Q, 128)
    r32 = rows.astype(I32)
    nib = jnp.where(
        (blk & 1)[:, None] == 1, (r32 >> 4) & 0xF, r32 & 0xF
    ).astype(jnp.int8)
    j = jnp.arange(LANE, dtype=I32)
    inmask = j[None, :] < within[:, None]
    sym = jnp.arange(NSYM, dtype=jnp.int8)
    eq = nib[:, :, None] == sym[None, None, :]
    inc = (eq & inmask[:, :, None]).sum(axis=1, dtype=I32)
    return base + inc.astype(I64)


def apply_insertions_packed(pbwt, n, pos, sym, stream, valid):
    """Merge on packed storage: unpack -> merge -> repack."""
    from .merge import apply_insertions

    sym_flat = unpack_bwt(pbwt)
    new = apply_insertions(sym_flat, n, pos, sym, stream, valid)
    return pack_bwt(jnp.where(new > 6, 6, new))
