"""Multi-device BCR under shard_map with explicit collectives.

The distributed backend the reference never had (SURVEY.md §2.1/§5, the
shared-memory pthread round of mrope.c:299-342 re-expressed over a device
mesh).  BOTH state axes are sharded:

* the flat BWT buffer by position range (shard s owns global capacity
  range [s*LCAP, (s+1)*LCAP)), with rank tables storing GLOBAL prefix
  counts (local tables + one all_gather of per-shard totals per round);
* the per-read BCR state by GLOBAL SORTED RANK: the stable bucket sort of
  each round doubles as a balanced re-shard — a padded all-to-all moves
  each read's (l, u, pk) record to the shard owning its sorted position
  (ShardComm.permute).  Plan scans then run on M/D local rows with
  cross-shard carries (ShardComm in parallel/comm.py); plan compute is
  data-parallel, not replicated.

Per round:

* rank queries are ROUTED: each shard sends its reads' interval-end
  positions to the shard whose BWT range contains them (padded
  all-to-all), the owner answers from its local global-valued tables, and
  the answers are routed back (the distributed rope_rank2a of mrope.c:202).
* insertions are ROUTED the same way by destination position; each shard
  then applies its received insertions to its window in one merge pass.
  All positions shift right monotonically, so a shard's output window
  additionally needs up to M trailing symbols from its LEFT neighbor,
  exchanged with one non-wrapping ppermute per round.
* the cross-bucket rebase (mrope.c:332-340) reductions ride psums.

See HACKING.md for the scaling model (collective volumes per round) and
the 1->8 device CPU-mesh shapes.

Multi-host (SURVEY.md §7.7): the same engine runs over a 2-D
``(host, shard)`` mesh — every collective takes the FLATTENED axis tuple
(shard index = host * S + s, host-major), so consecutive BWT position
ranges live within one host.  Traffic split under that layout:

* the sort re-shard moves each read record to the shard owning its global
  sorted rank; sorted ranks drift slowly between rounds, so most rows move
  between NEIGHBORING shards — inside one host, with only boundary rows
  crossing hosts over the network;
* rank/insert routing is near-uniform over shards for random batches, so
  a (D-S)/D share of routed rows crosses hosts and S/D stays local; the
  slot-capped exchange bounds the padded volume either way, and the
  psum'd overflow fallback stays global;
* the per-round rebase reductions (6x6 count matrix) and boundary
  ppermutes are O(bytes) — latency-bound, not bandwidth-bound.

Per-host input feeding: each host packs and feeds only its own read-state
rows (rows are sharded host-major), so batch ingest bandwidth scales with
hosts; see ``ShardedTpuBwt.insert_multi``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..alphabet import NSYM
from ..index.flat import PAD
from ..index.rank import build_block_tables, rank_global
from ..index.scan import cumsum_blocked
from ..engine.bcr import (
    FLUSH_PER_PEND_PLAIN,
    I32,
    I64,
    ReadStates,
    plan_round,
    _pad_pow2,
    _round_up,
)
from ..oracle import SO_IO
from .comm import ShardComm

AXIS = "s"


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedBwt:
    bwt: jax.Array  # int8[D, LCAP]   (sharded along axis 0)
    blk_prefix: jax.Array  # int[D, LCAP//K + 1, 6]  (GLOBAL values;
    # int32 while the global capacity fits — flat.table_dtype)
    n: jax.Array  # int64  (replicated)
    psize: jax.Array  # int64[6]
    pcounts: jax.Array  # int64[6,6]


def _routed_rank_fn(comm, bwt_loc, blkp_loc, lcap, K):
    """Global 6-symbol rank with all-to-all query routing: each query goes
    to the shard owning its position; owners answer from local tables
    (which hold GLOBAL prefix values); answers route back."""

    def rank_fn(gpos):
        q = gpos.shape[0]
        tgt = jnp.clip(gpos // lcap, 0, comm.d - 1).astype(I32)
        valid = jnp.ones(q, bool)
        # rank positions of a random batch route near-uniformly: c*Q/D
        # slots instead of worst-case Q (volume /(D/c)); the psum'd
        # overflow fallback keeps adversarial rounds exact
        s_cap = _slot_cap(q, comm.d)
        rv, (rq,), route = comm.exchange(tgt, valid, [gpos],
                                         slot_cap=s_cap)
        local = jnp.clip(rq - comm.s.astype(gpos.dtype) * lcap, 0, lcap)
        r = rank_global(bwt_loc, blkp_loc, local, K)
        return comm.reply(route, r)

    return rank_fn


def _slot_cap(q, d):
    """Concentration-aware slot capacity: 4x the uniform expectation,
    256-row aligned, never above the worst case."""
    if d <= 1:
        return None
    return min(q, _round_up(4 * q // d, 256))


def stitched_merge(bwt_loc, tail, ldest, rsym, s_lo):
    """Apply a shard's received insertions plus the cross-shard drift to
    its window: output position t holds the inserted symbol when t is a
    local destination, else stitched[m + t - s_lo - c(t)] with stitched =
    (left neighbor's m-symbol tail + window) and c(t) the inclusive count
    of local destinations up to t.  ``ldest`` holds window offsets
    (out-of-window rows are dropped), unique among the valid ones."""
    m = tail.shape[0]
    lcap = bwt_loc.shape[0]
    insmap = jnp.zeros((lcap,), jnp.int8)
    insmap = insmap.at[ldest].set(
        (rsym + 1).astype(jnp.int8), mode="drop", unique_indices=True
    )
    c_local = cumsum_blocked((insmap != 0).astype(I32))  # inclusive
    stitched = jnp.concatenate([tail, bwt_loc])  # (m + lcap,)
    src = m + jnp.arange(lcap, dtype=I32) - s_lo - c_local
    gathered = stitched[jnp.clip(src, 0, lcap + m - 1)]
    return jnp.where(insmap != 0, insmap - 1, gathered)


def _local_merge(comm, bwt_loc, gX, sym, stream, active, lcap, K):
    """Route this shard's planned insertions to their destination shards,
    then apply the received ones to this shard's window.  Returns the new
    local buffer and its new GLOBAL-valued rank table.

    Position arithmetic runs in gX's dtype (int32 while the global
    capacity fits — the driver picks it), and the tables in
    flat.table_dtype(cap)."""
    from ..index.flat import table_dtype

    s_idx = comm.s
    pdt = gX.dtype
    lo = s_idx.astype(pdt) * lcap

    dest = gX + stream.astype(pdt)
    tgt = jnp.clip(dest // lcap, 0, comm.d - 1).astype(I32)
    rv, (rdest, rsym), _ = comm.exchange(
        tgt, active, [dest, sym.astype(I32)],
        slot_cap=_slot_cap(gX.shape[0], comm.d),
    )

    # insertions below my range (for the rightward drift): per-owner
    # histogram of routed destinations, psum'd, prefix below me
    oh_t = (tgt[:, None] == jnp.arange(comm.d, dtype=I32)[None, :])
    hist = jax.lax.psum(
        jnp.sum(oh_t & active[:, None], axis=0, dtype=I32), comm.axis
    )
    s_lo = jnp.sum(
        jnp.where(jnp.arange(comm.d) < s_idx, hist, 0), dtype=I32
    )

    ldest = jnp.where(rv, rdest - lo, lcap)

    # left neighbor's tail covers the rightward drift (<= M per round)
    m = gX.shape[0] * comm.d  # global batch rows
    tail = bwt_loc[lcap - m :]
    tail = jax.lax.ppermute(
        tail, comm.axis, [(i, i + 1) for i in range(comm.d - 1)]
    )

    tdt = table_dtype(lcap * comm.d)
    new_loc = stitched_merge(bwt_loc, tail, ldest, rsym, s_lo)
    local_pref = build_block_tables(new_loc, K, dtype=tdt)

    # new local tables with global bases
    totals = local_pref[lcap // K]  # counts over the full window
    all_tot = jax.lax.all_gather(totals, comm.axis)  # (D, 6)
    base = jnp.concatenate(
        [jnp.zeros((1, NSYM), tdt), jnp.cumsum(all_tot, axis=0)[:-1]]
    )[s_idx]
    return new_loc, local_pref[: lcap // K + 1] + base[None, :]


# ---------------------------------------------------------------------------
# Deferred-merge sharded engine (multi-round insertion buffering per shard)
#
# The distributed re-expression of the single-device pending index
# (index/pending.py): each shard keeps a pending side index for insertions
# whose BASE position falls in its fixed range [s*lcap, (s+1)*lcap), stored
# in LOCAL coordinates vp_local = b + j_local (b = base insertion point,
# j_local = the entry's rank within this shard's pending set).  vp_local is
# INVARIANT under other shards' activity; the only global state is the
# replicated per-shard pending-count prefix ``ppref`` (D+1,) and occ prefix
# ``pocc`` (D, 6), updated with one small psum per round.
#
# Virtual-position algebra (all exact, no int64 vectors needed per shard):
#   V[s]            = s*lcap + ppref[s]     -- shard s's virtual range start
#   owner(g)        = s  with  V[s] <= g < V[s+1]  (V is ascending)
#   local virtual   gl = g - ppref[s]
#   pending below   p_loc = |{ vp_local < gl }|   (blocked descent)
#   base position   b  = gl - p_loc   -- provably in [s*lcap, (s+1)*lcap)
#   rank(g)         = base_rank(b - s*lcap) + pocc[s] + occ_loc
#
# Insertions route by owner(gX) (start-of-round coords); their local tie
# rank is stream - S0[owner] (owner stream ranges are contiguous because
# insertion points are non-decreasing in stream).  Every defer_r rounds
# each shard flushes its pending into its frozen base window locally, then
# ships its tail spill (the merged content past (s+1)*lcap, at most
# D*pcap symbols) one hop right — the flush-time analogue of the per-round
# drift stitch.  Constraint: D*pcap <= lcap (single-hop spill).
# ---------------------------------------------------------------------------


def _v_route(gpos, V):
    """Owner shard of each global virtual position: V is the replicated
    ascending (D+1,) boundary vector; owner = #(V[1:D] <= g)."""
    return jnp.sum(
        (gpos[:, None] >= V[None, 1:-1]).astype(I32), axis=1
    )


def _routed_rank_virtual_fn(comm, bwt_loc, blkp_loc, pend, lcap, K,
                            ppref, pocc):
    """Deferred-mode routed rank: owner answers from frozen base tables +
    its local pending index + the replicated below-shard prefixes.

    All owner-side arithmetic runs in WINDOW coordinates (wl = g -
    ppref[s] - s*lcap in [0, lcap + P_s)), so the pending index and the
    descent stay int32 regardless of the global capacity."""
    from ..index.pending import pending_rank

    def rank_fn(gpos):
        pdt = gpos.dtype
        V = (
            jnp.arange(comm.d + 1, dtype=pdt) * lcap
            + ppref.astype(pdt)
        )
        tgt = _v_route(gpos, V)
        valid = jnp.ones(gpos.shape[0], bool)
        rv, (rq,), route = comm.exchange(
            tgt, valid, [gpos], slot_cap=_slot_cap(gpos.shape[0], comm.d)
        )
        lpdt = pend.vp.dtype
        my_v0 = ppref[comm.s].astype(pdt) + comm.s.astype(pdt) * lcap
        wl = jnp.clip(rq - my_v0, 0, lcap + pend.cap).astype(lpdt)
        p_loc, occ_loc = pending_rank(pend, wl)
        loff = jnp.clip(wl - p_loc, 0, lcap)
        base = rank_global(bwt_loc, blkp_loc, loff, K)
        ans = (
            base
            + pocc[comm.s][None, :].astype(base.dtype)
            + occ_loc.astype(base.dtype)
        )
        return comm.reply(route, ans)

    return rank_fn


def _pending_route_add(comm, pend, gX, sym, stream, active, lcap,
                       ppref, pocc):
    """Route one round's insertions to their owner shards (by V-interval of
    the start-of-round insertion point) and merge them into each owner's
    local pending index; update the replicated prefixes."""
    from ..index.pending import pending_add

    from ..index.scan import _EXACT

    pdt = gX.dtype
    V = jnp.arange(comm.d + 1, dtype=pdt) * lcap + ppref.astype(pdt)
    tgt = _v_route(gX, V)
    # per-owner insertion counts and per-owner/per-symbol occ, psum'd
    oh_t = (tgt[:, None] == jnp.arange(comm.d, dtype=I32)[None, :])
    oh_t = oh_t & active[:, None]
    hist = jax.lax.psum(jnp.sum(oh_t, axis=0, dtype=I32), comm.axis)
    ohs = (sym[:, None] == jnp.arange(NSYM, dtype=I32)[None, :])
    occ_add = jax.lax.psum(
        jnp.einsum(
            "md,ms->ds", oh_t.astype(jnp.float32),
            ohs.astype(jnp.float32), precision=_EXACT,
        ).astype(I32),
        comm.axis,
    )
    S0 = jnp.concatenate(
        [jnp.zeros(1, I32), jnp.cumsum(hist)]
    )  # (D+1,) exclusive stream prefix per owner

    rv, (rgX, rsym, rstream), _ = comm.exchange(
        tgt, active, [gX, sym, stream.astype(I32)],
        slot_cap=_slot_cap(gX.shape[0], comm.d),
    )
    lpdt = pend.vp.dtype
    my_v0 = ppref[comm.s].astype(pdt) + comm.s.astype(pdt) * lcap
    wl = jnp.clip(rgX - my_v0, 0, lcap + pend.cap).astype(lpdt)
    stream_loc = rstream - S0[comm.s]
    pend = pending_add(pend, wl, rsym, stream_loc, rv)

    new_ppref = ppref + S0
    new_pocc = pocc + jnp.concatenate(
        [jnp.zeros((1, NSYM), I32), jnp.cumsum(occ_add, axis=0)[:-1]]
    )
    return pend, new_ppref, new_pocc


def _tables_with_global_base(comm, new_loc, lcap, K):
    from ..index.flat import table_dtype

    tdt = table_dtype(lcap * comm.d)
    local_pref = build_block_tables(new_loc, K, dtype=tdt)
    totals = local_pref[-1]
    all_tot = jax.lax.all_gather(totals, comm.axis)
    base = jnp.concatenate(
        [jnp.zeros((1, NSYM), tdt), jnp.cumsum(all_tot, axis=0)[:-1]]
    )[comm.s]
    return local_pref + base[None, :]


def _flush_sharded(comm, bwt_loc, pend, lcap, K, ppref):
    """Materialize each shard's pending into its base window and re-align
    windows to the fixed base ranges: local coalesced merge into a
    (lcap + D*pcap) scratch, then ship the tail spill one hop right."""
    from ..index.merge import apply_insertions
    from ..index.pending import pending_flush_args

    pcap = pend.cap
    SPILL = comm.d * pcap
    lpdt = pend.vp.dtype

    pos, sym, stream, valid = pending_flush_args(pend)
    # pos = vp_local - i are already WINDOW-local base positions [0, lcap)
    pos_loc = jnp.clip(pos, 0, lcap).astype(lpdt)
    scratch = jnp.concatenate(
        [bwt_loc, jnp.full((SPILL,), PAD, jnp.int8)]
    )
    merged = apply_insertions(
        scratch, None, pos_loc, sym, stream.astype(lpdt), valid
    )

    my_pp = ppref[comm.s]
    start = jnp.clip(lcap - my_pp, 0, lcap).astype(I32)
    spill = jax.lax.dynamic_slice(merged, (start,), (SPILL,))
    incoming = jax.lax.ppermute(
        spill, comm.axis, [(i, i + 1) for i in range(comm.d - 1)]
    )
    head = jnp.concatenate(
        [incoming, jnp.full((max(lcap - SPILL, 0),), PAD, jnp.int8)]
    )[:lcap]
    ext = jnp.concatenate([jnp.zeros((SPILL,), jnp.int8), merged[:lcap]])
    body = jax.lax.dynamic_slice(
        ext, ((SPILL - my_pp).astype(I32),), (lcap,)
    )
    iota = jnp.arange(lcap, dtype=I32)
    new_loc = jnp.where(iota < my_pp, head, body)
    return new_loc, _tables_with_global_base(comm, new_loc, lcap, K)


def sharded_bcr_batch_deferred_impl(state, reads, buf, n_rounds, *, K, so,
                                    lcap, d, axes, defer_r, pcap):
    from ..index.pending import empty_pending, reset_pending

    ml = reads.l.shape[0]
    comm = ShardComm(axes, ml, d)
    nr = n_rounds.astype(I32)
    pend0 = empty_pending(pcap, I32)
    n_super = (nr + defer_r - 1) // defer_r

    def outer(sidx, carry):
        st, rd, pend = carry
        bwt_loc = st.bwt[0]
        blkp_loc = st.blk_prefix[0]
        lo = sidx * defer_r
        ppref0 = jnp.zeros((d + 1,), I32)
        pocc0 = jnp.zeros((d, NSYM), I32)

        def inner(dcol, c):
            (n, psize, pcounts), rd, pend, ppref, pocc = c
            rank_fn = _routed_rank_virtual_fn(
                comm, bwt_loc, blkp_loc, pend, lcap, K, ppref, pocc
            )
            new_rd, gX, sym, stream, active, insb, n_ins = plan_round(
                psize, pcounts, rd, buf, dcol.astype(I32), dcol == 0,
                rank_fn, so=so, comm=comm,
            )
            pend, ppref, pocc = _pending_route_add(
                comm, pend, gX, sym, stream, active, lcap, ppref, pocc
            )
            return (
                (n + n_ins, psize + jnp.sum(insb, axis=1),
                 pcounts + insb),
                new_rd, pend, ppref, pocc,
            )

        (nn, psz, pc), rd, pend, ppref, _ = jax.lax.fori_loop(
            lo, jnp.minimum(lo + defer_r, nr), inner,
            ((st.n, st.psize, st.pcounts), rd, pend, ppref0, pocc0),
        )
        new_loc, new_blkp = _flush_sharded(
            comm, bwt_loc, pend, lcap, K, ppref
        )
        st = ShardedBwt(
            bwt=new_loc[None], blk_prefix=new_blkp[None],
            n=nn, psize=psz, pcounts=pc,
        )
        return st, rd, reset_pending(pend)

    st, rd, _ = jax.lax.fori_loop(
        0, n_super, outer, (state, reads, pend0)
    )
    return st, rd


def sharded_bcr_batch_impl(state, reads, buf, n_rounds, *, K, so, lcap, d,
                           axes=AXIS, defer_r=0, pcap=0):
    if defer_r > 0:
        return sharded_bcr_batch_deferred_impl(
            state, reads, buf, n_rounds, K=K, so=so, lcap=lcap, d=d,
            axes=axes, defer_r=defer_r, pcap=pcap,
        )
    ml = reads.l.shape[0]  # local read rows
    comm = ShardComm(axes, ml, d)

    def round_body(rd_idx, carry):
        st, rd = carry
        bwt_loc = st.bwt[0]
        blkp_loc = st.blk_prefix[0]
        rank_fn = _routed_rank_fn(comm, bwt_loc, blkp_loc, lcap, K)
        new_reads, gX, sym, stream, active, ins_bucket, n_ins = plan_round(
            st.psize, st.pcounts, rd, buf, rd_idx.astype(I32), rd_idx == 0,
            rank_fn, so=so, comm=comm,
        )
        new_loc, new_blkp = _local_merge(
            comm, bwt_loc, gX, sym, stream, active, lcap, K
        )
        new_state = ShardedBwt(
            bwt=new_loc[None],
            blk_prefix=new_blkp[None],
            n=st.n + n_ins,
            psize=st.psize + jnp.sum(ins_bucket, axis=1),
            pcounts=st.pcounts + ins_bucket,
        )
        return new_state, new_reads

    return jax.lax.fori_loop(0, n_rounds, round_body, (state, reads))


@functools.partial(
    jax.jit,
    static_argnames=("K", "so", "lcap", "mesh", "d", "defer_r", "pcap"),
    donate_argnums=(0, 1),
)
def sharded_bcr_batch(state, reads, buf, n_rounds, *, K, so, lcap, mesh, d,
                      defer_r=0, pcap=0):
    axes = tuple(mesh.axis_names)  # 1-D ("s",) or 2-D ("h", "s")
    shard = P(axes)
    rep = P()
    state_specs = ShardedBwt(
        bwt=shard, blk_prefix=shard, n=rep, psize=rep, pcounts=rep
    )
    read_specs = ReadStates(l=shard, u=shard, pk=shard)
    fn = shard_map(
        functools.partial(
            sharded_bcr_batch_impl, K=K, so=so, lcap=lcap, d=d, axes=axes,
            defer_r=defer_r, pcap=pcap,
        ),
        mesh=mesh,
        # buf sharded by byte range (comm.fetch_syms routes the per-round
        # next-symbol lookups to owners — no full replication)
        in_specs=(state_specs, read_specs, shard, rep),
        out_specs=(state_specs, read_specs),
        check_vma=False,
    )
    return fn(state, reads, buf, n_rounds)


class ShardedTpuBwt:
    """Multi-device BWT builder: same API surface as TpuBwt; BWT sharded by
    position range, read state sharded by sorted rank over a 1-D mesh."""

    def __init__(self, so=SO_IO, K=128, mesh=None, defer_r=None):
        # K=128 matches the single-device default (engine/bcr.py)
        if mesh is None:
            from .mesh import make_mesh

            mesh = make_mesh(axis=AXIS)
        self.mesh = mesh
        self.d = mesh.devices.size
        self.so = so
        self.K = K
        self._n = 0
        self._n_strings = 0
        self.state = None  # created lazily at first plan
        self._lcap = 0
        self._seed = None  # (flat_bwt, psize, pcounts) from a restore
        # deferred-merge depth: -1 auto, 0 off, >0 fixed (same knob as the
        # single-device engine)
        if defer_r is None:
            import os

            defer_r = int(os.environ.get("ROPEBWT2_TPU_DEFER_R", "-1"))
        self._defer_cfg = defer_r

    def _choose_defer(self, mpad):
        """(defer_r, pcap) for the next batch.  pcap is per SHARD, sized
        for the adversarial worst case (every insertion of every deferred
        round routed to one shard); deferral is disabled when the flush
        spill buffer D*pcap would not fit a single hop (> lcap) or the
        window coordinates would leave int32."""
        from ..index.pending import pending_cap

        if self._defer_cfg >= 0:
            r = self._defer_cfg
        else:
            import math

            ratio = FLUSH_PER_PEND_PLAIN * self._lcap * self.d / max(mpad, 1)
            r = int(math.sqrt(ratio)) if ratio >= 1 else 0
            if r < 4:  # shallow deferral loses (see TpuBwt._choose_defer)
                r = 0
            else:
                r = 1 << min(6, (r - 1).bit_length())
        while r > 1:
            pcap = pending_cap(mpad, r)
            if (
                self.d * pcap <= self._lcap
                and self._lcap + self.d * pcap < (1 << 31)
            ):
                return r, pcap
            r //= 2
        return 0, 0

    @classmethod
    def from_single(cls, single, mesh=None):
        """Adopt a single-device TpuBwt's index (the FMR ``-i`` restore
        path, mr_restore -> distributed engine): the flat BWT is re-sharded
        by position range at the next capacity plan."""
        eng = cls(so=single.so, K=single.K, mesh=mesh)
        eng._n = single._n
        eng._n_strings = single._n_strings
        eng._seed = (
            single.bwt_array(),
            np.asarray(single.state.psize),
            np.asarray(single.state.pcounts),
        )
        eng._plan(0)  # install the sharded state now (counts()/export work
        # even if no further batch is inserted)
        return eng

    # --- capacity planning (host-side; re-sharding copies the buffer) ---

    def _plan(self, extra):
        need = self._n + extra
        if self.state is not None and need <= self._lcap * self.d:
            return
        lcap = _round_up(
            _pad_pow2(-(-need // self.d), lo=max(self.K, 4096)), self.K
        )
        if self.state is not None:
            old, old_psize, old_pcounts = (
                self.bwt_array(),
                np.asarray(self.state.psize),
                np.asarray(self.state.pcounts),
            )
        elif self._seed is not None:
            old, old_psize, old_pcounts = self._seed
            self._seed = None
        else:
            old = None
            old_psize = np.zeros(NSYM, np.int64)
            old_pcounts = np.zeros((NSYM, NSYM), np.int64)
        cap = lcap * self.d
        flat = np.full(cap, PAD, dtype=np.int8)
        if old is not None:
            flat[: len(old)] = old
        bwt = flat.reshape(self.d, lcap)
        # per-shard tables with global bases, vectorized over shards
        from ..index.flat import table_dtype

        tdt = table_dtype(cap)
        jb = jnp.asarray(bwt)
        local = jax.vmap(
            lambda b: build_block_tables(b, self.K, dtype=tdt)
        )(jb)
        tot = np.asarray(local[:, -1, :])  # (D, 6)
        run = np.concatenate(
            [np.zeros((1, NSYM), np.int64), np.cumsum(tot, axis=0)[:-1]]
        )
        blkp = (np.asarray(local) + run[:, None, :]).astype(
            np.asarray(local).dtype
        )
        psize, pcounts = old_psize, old_pcounts
        sh = NamedSharding(self.mesh, P(tuple(self.mesh.axis_names)))
        rep = NamedSharding(self.mesh, P())
        self.state = ShardedBwt(
            bwt=jax.device_put(jnp.asarray(bwt), sh),
            blk_prefix=jax.device_put(jnp.asarray(blkp), sh),
            n=jax.device_put(jnp.asarray(self._n, dtype=jnp.int64), rep),
            psize=jax.device_put(jnp.asarray(psize), rep),
            pcounts=jax.device_put(jnp.asarray(pcounts), rep),
        )
        self._lcap = lcap

    def insert_multi(self, reads, already_reversed=False):
        m = len(reads)
        if m == 0:
            return
        lens = np.array([len(r) for r in reads], dtype=np.int32)
        total = int(lens.sum()) + m
        self._plan(total)
        # mpad must divide evenly across the mesh (ShardComm assumes exact
        # ml = mpad / d); _pad_pow2 alone is not a multiple of non-pow2 d
        mpad = _round_up(max(_pad_pow2(m), self.d), self.d)
        if mpad > self._lcap:  # drift guard: one round inserts <= mpad
            self._plan(self._n + total + mpad * self.d)
        # vectorized aligned packing (one scatter, no per-read Python loop);
        # bufcap divisible by d*8: the buffer ships SHARDED by byte range
        strides = ((lens.astype(np.int64) + 8) & ~np.int64(7))
        starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
        bufcap = _round_up(
            _pad_pow2(int(strides.sum()), lo=64), self.d * 8
        )
        buf = np.zeros(bufcap, dtype=np.int8)
        if isinstance(reads, np.ndarray) and reads.ndim == 2:
            flat = reads.astype(np.int8, copy=False)
            if not already_reversed:
                flat = flat[:, ::-1]
            ln = reads.shape[1]
            buf.reshape(-1, 8)[: m * int(strides[0]) // 8].reshape(
                m, int(strides[0])
            )[:, :ln] = flat
        else:
            cat = np.concatenate(
                [np.asarray(r, dtype=np.int8) for r in reads]
            ) if m else np.zeros(0, np.int8)
            rstarts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            if not already_reversed:
                # in-place reversal per read: index each read backwards
                idx = (rstarts + lens - 1).repeat(lens) - (
                    np.arange(int(lens.sum())) - rstarts.repeat(lens)
                )
                cat = cat[idx]
            dst = (starts - rstarts).repeat(lens) + np.arange(
                int(lens.sum()), dtype=np.int64
            )
            buf[dst] = cat
        # int32 positions whenever the global capacity (and buffer) fit
        cap = self._lcap * self.d
        pdt = np.int32 if cap < (1 << 31) - 1 else np.int64
        pkdt = np.int32 if bufcap <= (1 << 30) else np.int64
        npad = mpad - m
        pk = np.full(mpad, -1, dtype=pkdt)
        pk[npad:] = starts  # 8-aligned: off == (off//8)<<3, c = 0
        l = np.zeros(mpad, dtype=pdt)
        u = np.zeros(mpad, dtype=pdt)
        if self.so == SO_IO:
            l[npad:] = self._n_strings + np.arange(m)
            u[npad:] = l[npad:]
        else:
            u[npad:] = self._n_strings
        sh = NamedSharding(self.mesh, P(tuple(self.mesh.axis_names)))
        rep = NamedSharding(self.mesh, P())
        rs = ReadStates(
            l=jax.device_put(jnp.asarray(l), sh),
            u=jax.device_put(jnp.asarray(u), sh),
            pk=jax.device_put(jnp.asarray(pk), sh),
        )
        jbuf = jax.device_put(jnp.asarray(buf), sh)  # sharded by byte range
        defer_r, pcap = self._choose_defer(mpad)
        self.state, _ = sharded_bcr_batch(
            self.state,
            rs,
            jbuf,
            jnp.asarray(int(lens.max()) + 1, dtype=I64),
            K=self.K,
            so=self.so,
            lcap=self._lcap,
            mesh=self.mesh,
            d=self.d,
            defer_r=defer_r,
            pcap=pcap,
        )
        self._n += total
        self._n_strings += m

    def insert_nul_batch(self, nulbuf):
        """Batch given as NUL-terminated insertion-oriented strings."""
        nulbuf = np.ascontiguousarray(nulbuf).view(np.int8)
        ends = np.flatnonzero(nulbuf == 0)
        if len(ends) == 0:
            return
        starts = np.concatenate([[0], ends[:-1] + 1])
        reads = [nulbuf[s:e] for s, e in zip(starts, ends)]
        self.insert_multi(reads, already_reversed=True)

    @property
    def n(self):
        return self._n

    def counts(self):
        return np.asarray(self.state.pcounts.sum(axis=0))

    def bwt_array(self):
        return np.asarray(self.state.bwt).reshape(-1)[: self._n]

    def runs(self):
        b = self.bwt_array()
        if b.size == 0:
            return []
        change = np.flatnonzero(np.diff(b)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [b.size]])
        return [(int(b[s]), int(e - s)) for s, e in zip(starts, ends)]
