"""Pending-insertion side index: multi-round insertion buffering.

The flat-rebuild design pays O(live prefix) per BCR round (every round
rewrites the whole buffer), where the reference's rope pays O(log n) per
symbol (rope.c:114-148).  At Gsym scale that makes the merge the entire
cost.  This module defers the rewrite: the base buffer (and its rank
tables) stays FROZEN for R rounds while insertions accumulate in a sorted
side index; rank queries against the virtual (base + pending) sequence are
answered as

    rank_virtual(g) = rank_base(g - p) + pending_prefix(p),
    p = |{ i : vp[i] < g }|  (searchsorted into the sorted vp array)

because the first g virtual positions contain exactly p pending symbols
and g - p base symbols (base order is preserved by insertion).  Every R
rounds the pending set is flushed into the base with ONE coalesced merge
pass — dividing the full-prefix merge traffic by R at the cost of
O(P)-sized vector work per round (P <= R * batch rows).

Representation (all device-resident, static capacity Pcap):

* ``vp``   int[Pcap]  virtual positions of the pending insertions in the
           CURRENT coordinate system, strictly increasing; rows >= P hold
           an INF sentinel (> any valid position).
* ``psym`` int8[Pcap] inserted symbols; PAD (=6) beyond P.
* ``blk_prefix`` int32[Pcap//KP+1, 6] per-symbol prefix counts at KP-block
           boundaries of psym — the same rank structure as the base buffer
           (index/rank.py), rebuilt after each round's merge-in.
* ``p``    int32 scalar, live count.

Merging one round's insertions (gX = old-coordinate insertion points,
stream = tie ranks; dest = gX + stream are the unique NEW-coordinate
positions) into the pending set is a merge of two sorted sequences,
computed without a comparison sort:

1. dest, ordered by stream, is already sorted ascending (dest is strictly
   increasing in stream) -> ONE M-sized scatter produces the sorted new
   block qs (INF-filled beyond the round's A live insertions).
2. old pending rows shift by s[i] = |{ j : gX[j] <= vp[i] }| (the standard
   old-element shift of a batch insertion): one searchsorted of gX into
   vp gives each insertion's first affected row, a histogram + inclusive
   cumsum turns that into s.
3. the merged order interleaves old rows (at vp + s) and new rows (at qs),
   which are disjoint position sets: t[j] = searchsorted(vp + s, qs[j])
   places new row j at merged slot j + t[j], and the same histogram trick
   on t places old row i at slot i + r[i], r[i] = |{ live j : t[j] <= i }|.

Flushing the pending set into the base reuses the normal merge machinery
verbatim: row i is an insertion at base position vp[i] - i with tie rank i
(destination vp[i] - i + i = vp[i], its virtual position — by definition).

Matches the role of the reference's rope buffering economics
(/root/reference/rope.c:114-148, mrope.c:299-342); no structural
counterpart exists in the reference — this is the device re-expression.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..alphabet import NSYM
from .flat import PAD
from .rank import build_block_tables, rank_global
from .scan import cumsum_blocked

KP = 128  # pending rank-table block size (one gather lane row per query)
I32 = jnp.int32
_F = 128  # searchsorted_blocked fanout (one gather lane row per level)


def searchsorted_blocked(vp, g):
    """count[q] = |{ i : vp[i] < g[q] }| for sorted ``vp`` — the
    side='left' searchsorted as a blocked descent — the same structure as
    the BWT rank path (index/rank.py): ceil(log128(N)) - 1 row gathers of
    (Q, 128) plus vectorized compare-counts, where jnp.searchsorted runs a
    log2(N)-step loop of dependent element gathers.

    Descent invariant: for sorted a and heads h = a[::F], the F-block of
    ``a`` containing the last element < g is j = max(#(h < g) - 1, 0), and
    the final count is j*F + #(a[j*F:(j+1)*F] < g).  Requires len(vp) to
    be a multiple of 128; tail rows must hold +INF-like sentinels (they do:
    vp is INF-filled beyond p)."""
    n = vp.shape[0]
    assert n % _F == 0, n
    levels = [vp]
    while levels[-1].shape[0] > _F:
        nxt = levels[-1][::_F]
        if nxt.shape[0] % _F and nxt.shape[0] > _F:
            pad = _F - nxt.shape[0] % _F
            nxt = jnp.concatenate(
                [nxt, jnp.full((pad,), jnp.iinfo(vp.dtype).max, vp.dtype)]
            )
        levels.append(nxt)
    gq = g[:, None].astype(vp.dtype)
    top = levels[-1]
    cnt = jnp.sum(_lt(top[None, :], gq), axis=1, dtype=I32)  # (Q,)
    j = jnp.maximum(cnt - 1, 0)
    for lvl in levels[-2::-1]:
        rows = lvl.reshape(-1, _F)[j]  # (Q, F) gather
        c = jnp.sum(_lt(rows, gq), axis=1, dtype=I32)
        j = jnp.maximum(j * _F + c - 1, 0)
    # the last iteration above ended at vp itself: recover the count from
    # the final block index + in-block count (j currently = count - 1
    # clamped at 0; disambiguate count 0 with one more compare of vp[0])
    zero = vp[0] >= g.astype(vp.dtype)
    return jnp.where(zero, 0, j + 1).astype(I32)


def _inf(pdt):
    """Sentinel for empty vp rows: above any valid position, with enough
    headroom that sentinel + per-cycle shifts never overflow (shifts are
    clamped back to INF every round)."""
    return jnp.iinfo(pdt).max - (1 << 28)


def _lt(rows, gq):
    """rows < gq, elementwise with broadcasting.  For int64 operands the
    compare runs as a hi/lo 32-bit pair compare (bitcast).  Values are
    non-negative (positions + the INF sentinel), so the signed-hi /
    unsigned-lo composite ordering is exact."""
    if rows.dtype != jnp.int64:
        return rows < gq
    r = jax.lax.bitcast_convert_type(rows, jnp.uint32)  # (..., 2) [lo, hi]
    q = jax.lax.bitcast_convert_type(
        jnp.broadcast_to(gq, jnp.broadcast_shapes(rows.shape, gq.shape)),
        jnp.uint32,
    )
    rhi = r[..., 1].astype(I32)
    qhi = q[..., 1].astype(I32)
    return (rhi < qhi) | ((rhi == qhi) & (r[..., 0] < q[..., 0]))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PendingIndex:
    vp: jax.Array  # pdt[Pcap] sorted virtual positions (INF sentinels)
    psym: jax.Array  # int8[Pcap] symbols (PAD sentinels)
    blk_prefix: jax.Array  # int32[Pcap//KP+1, 6]
    p: jax.Array  # int32 scalar live count

    @property
    def cap(self) -> int:
        return self.vp.shape[0]


def pending_cap(max_rows_per_round: int, R: int) -> int:
    """Static pending capacity for R rounds of <= max_rows_per_round
    insertions, padded to the lcm of the scan window (256) and KP."""
    need = max(max_rows_per_round * R, 256)
    return -(-need // 256) * 256


def empty_pending(pcap: int, pdt) -> PendingIndex:
    assert pcap % 256 == 0 and pcap % KP == 0
    return PendingIndex(
        vp=jnp.full((pcap,), _inf(pdt), dtype=pdt),
        psym=jnp.full((pcap,), PAD, dtype=jnp.int8),
        blk_prefix=jnp.zeros((pcap // KP + 1, NSYM), dtype=I32),
        p=jnp.zeros((), dtype=I32),
    )


def reset_pending(pend: PendingIndex) -> PendingIndex:
    pdt = pend.vp.dtype
    return PendingIndex(
        vp=jnp.full_like(pend.vp, _inf(pdt)),
        psym=jnp.full_like(pend.psym, PAD),
        blk_prefix=jnp.zeros_like(pend.blk_prefix),
        p=jnp.zeros_like(pend.p),
    )


def pending_rank(pend: PendingIndex, g):
    """(p, occ): p[q] = |{ i : vp[i] < g[q] }| and occ[q, s] = count of
    symbol s among those pending rows.

    The searchsorted descent is FUSED with the pending symbol rank: the
    final level's block index addresses BOTH the vp row (count < g) and
    the psym row + its table row, saving one (Q, 128) gather per call vs
    a separate rank_global."""
    vp = pend.vp
    n = vp.shape[0]
    assert n % _F == 0, n
    levels = [vp]
    while levels[-1].shape[0] > _F:
        nxt = levels[-1][::_F]
        if nxt.shape[0] % _F and nxt.shape[0] > _F:
            pad = _F - nxt.shape[0] % _F
            nxt = jnp.concatenate(
                [nxt, jnp.full((pad,), jnp.iinfo(vp.dtype).max, vp.dtype)]
            )
        levels.append(nxt)
    gq = g[:, None].astype(vp.dtype)
    top = levels[-1]
    cnt = jnp.sum(_lt(top[None, :], gq), axis=1, dtype=I32)
    j = jnp.maximum(cnt - 1, 0)
    for lvl in levels[-2:0:-1]:  # down to (but excluding) vp itself
        rows = lvl.reshape(-1, _F)[j]
        c = jnp.sum(_lt(rows, gq), axis=1, dtype=I32)
        j = jnp.maximum(j * _F + c - 1, 0)
    jb = j  # final 128-block of vp containing the boundary
    vrows = vp.reshape(-1, _F)[jb]
    inb = _lt(vrows, gq)  # (Q, 128) membership mask
    c = jnp.sum(inb, axis=1, dtype=I32)
    p = jb * _F + c
    srows = pend.psym.reshape(-1, _F)[jb]  # (Q, 128) int8
    sym = jnp.arange(NSYM, dtype=pend.psym.dtype)
    eq = (srows[:, :, None] == sym[None, None, :]) & inb[:, :, None]
    occ = pend.blk_prefix[jb] + eq.sum(axis=1, dtype=I32)
    return p, occ


def pending_rank2(pend: PendingIndex, gl, gu):
    """Fused two-point pending rank for NARROW intervals: (pl, occl, pu,
    occu) with the PRECONDITION 0 <= gu - gl <= KP per query.  Then the
    number of pending rows in [gl, gu) is <= KP (each row IS one virtual
    symbol), so both boundaries live in one adjacent block pair: one
    descent + ONE paired row gather serves both ends."""
    vp = pend.vp
    n = vp.shape[0]
    assert n % _F == 0, n
    levels = [vp]
    while levels[-1].shape[0] > _F:
        nxt = levels[-1][::_F]
        if nxt.shape[0] % _F and nxt.shape[0] > _F:
            pad = _F - nxt.shape[0] % _F
            nxt = jnp.concatenate(
                [nxt, jnp.full((pad,), jnp.iinfo(vp.dtype).max, vp.dtype)]
            )
        levels.append(nxt)
    glq = gl[:, None].astype(vp.dtype)
    guq = gu[:, None].astype(vp.dtype)
    top = levels[-1]
    cnt = jnp.sum(_lt(top[None, :], glq), axis=1, dtype=I32)
    j = jnp.maximum(cnt - 1, 0)
    for lvl in levels[-2:0:-1]:
        rows = lvl.reshape(-1, _F)[j]
        c = jnp.sum(_lt(rows, glq), axis=1, dtype=I32)
        j = jnp.maximum(j * _F + c - 1, 0)
    nbk = n // _F
    jc = jnp.clip(j, 0, max(nbk - 2, 0)).astype(I32)

    def pair_gather(arr2d, sizes):
        del sizes
        return arr2d[
            jc[:, None] + jnp.arange(2, dtype=I32)[None, :]
        ].reshape(-1, 2 * _F)

    vpair = pair_gather(vp.reshape(-1, _F), (2, _F))
    spair = pair_gather(pend.psym.reshape(-1, _F), (2, _F))
    inl = _lt(vpair, glq)
    inu = _lt(vpair, guq)
    pl = jc * _F + jnp.sum(inl, axis=1, dtype=I32)
    pu = jc * _F + jnp.sum(inu, axis=1, dtype=I32)
    base = pend.blk_prefix[jc]
    sym = jnp.arange(NSYM, dtype=pend.psym.dtype)
    eq = spair[:, :, None] == sym[None, None, :]
    occl = base + (eq & inl[:, :, None]).sum(axis=1, dtype=I32)
    occu = base + (eq & inu[:, :, None]).sum(axis=1, dtype=I32)
    return pl, occl, pu, occu


def rank_virtual2_base(base2_fn, pend: PendingIndex, gl, gu):
    """Fused two-point rank_virtual (precondition gu - gl <= KP):
    base2_fn(bl, bu) -> (occl, occu) over the base with bu - bl <= KP
    guaranteed (pending rows in [gl, gu) shrink the base interval)."""
    pl, el, pu, eu = pending_rank2(pend, gl, gu)
    bl, bu = base2_fn(gl - pl.astype(gl.dtype), gu - pu.astype(gu.dtype))
    return bl + el.astype(bl.dtype), bu + eu.astype(bu.dtype)


def rank_virtual(bwt, blk_prefix, pend: PendingIndex, g, K: int):
    """6-symbol rank of the virtual (base + pending) sequence at positions
    ``g`` (0 <= g <= n_virtual).  Returns (Q, 6) in blk_prefix's dtype."""
    p, extra = pending_rank(pend, g)
    base = rank_global(bwt, blk_prefix, g - p.astype(g.dtype), K)
    return base + extra.astype(base.dtype)


def rank_virtual_base(base_rank_fn, pend: PendingIndex, g):
    """rank_virtual with an abstract base: base_rank_fn(pos) -> (Q, 6).
    Used by the packed-storage and sharded engines."""
    p, extra = pending_rank(pend, g)
    base = base_rank_fn(g - p.astype(g.dtype))
    return base + extra.astype(base.dtype)


def pending_add(pend: PendingIndex, gX, sym, stream, active) -> PendingIndex:
    """Merge one round's insertions into the pending set (see module doc).

    gX/stream: int[M] old-coordinate insertion points and tie ranks (tie
    ranks unique in [0, A) over the A active rows, dest = gX + stream
    strictly increasing in stream).  sym: int32[M].  active: bool[M].

    New row (tie rank r, insertion point gX) lands at merged slot r + k
    with k = |{ i : vp[i] < gX }| — the searchsorted of the shifted-old
    sequence at the new row's destination reduces to k exactly (old row i
    with vp[i] < gX has shift s[i] <= r, so vp[i]+s[i] < gX+r; old row
    with vp[i] >= gX has s[i] >= r+1, so vp[i]+s[i] > gX+r), which kills
    the second searchsorted AND the intermediate sorted-new-block scatter:
    both payloads scatter directly to merged slots.  Old rows move by a
    log-shift expand (slot i takes old row i - c(i), c = inclusive count
    of new rows up to i), exact because c is non-decreasing with slope
    <= 1."""
    pcap = pend.cap
    pdt = pend.vp.dtype
    m = gX.shape[0]
    INF = _inf(pdt)
    vp = pend.vp

    # k[row] = |{ i : vp[i] < gX[row] }|; also the new row's slot offset
    gq = jnp.where(active, gX, INF).astype(pdt)
    k = searchsorted_blocked(vp, gq)

    # old-row shifts s[i] = |{ rows : k[row] <= i }| via histogram + scan
    hist = jnp.zeros((pcap,), I32)
    hist = hist.at[jnp.where(active, k, pcap)].add(1, mode="drop")
    s = cumsum_blocked(hist)
    vps = jnp.minimum(vp + s.astype(pdt), INF)  # shifted old rows (sorted)

    # two narrow scatters place every new row at its merged slot
    merged_slot = jnp.where(
        active, stream.astype(I32) + k, pcap
    )
    sarr = jnp.zeros((pcap,), jnp.int8).at[merged_slot].set(
        jnp.where(active, sym + 1, 0).astype(jnp.int8),
        mode="drop", unique_indices=True,
    )
    varr = jnp.zeros((pcap,), pdt).at[merged_slot].set(
        jnp.where(active, gX + stream, 0).astype(pdt),
        mode="drop", unique_indices=True,
    )

    is_new = sarr != 0

    # old rows: log-shift expand by c = prefix of is_new
    c = cumsum_blocked(is_new.astype(I32))
    vo, so_ = vps, pend.psym
    nbits = max(m.bit_length(), 1)
    for kk in range(nbits - 1, -1, -1):
        step = 1 << kk
        if step >= pcap:
            continue
        take = ((c >> kk) & 1) == 1
        vo = jnp.where(
            take,
            jnp.concatenate([jnp.full((step,), INF, pdt), vo[:-step]]),
            vo,
        )
        so_ = jnp.where(
            take,
            jnp.concatenate([jnp.full((step,), PAD, jnp.int8), so_[:-step]]),
            so_,
        )
    new_vp = jnp.where(is_new, varr, vo)
    new_sym = jnp.where(is_new, sarr - 1, so_)

    n_new = jnp.sum(active, dtype=I32)
    return PendingIndex(
        vp=new_vp,
        psym=new_sym,
        blk_prefix=build_block_tables(new_sym, KP, dtype=I32),
        p=pend.p + n_new,
    )


def pending_flush_args(pend: PendingIndex):
    """(pos, sym, stream, valid) for the base merge: row i is an insertion
    at base position vp[i] - i with tie rank i."""
    pcap = pend.cap
    pdt = pend.vp.dtype
    iota = jnp.arange(pcap, dtype=pdt)
    valid = iota < pend.p.astype(pdt)
    pos = jnp.where(valid, pend.vp - iota, 0)
    return pos, pend.psym.astype(I32), iota, valid
