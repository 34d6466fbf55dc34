"""Batched BCR construction on device: a data-parallel re-expression of
mr_insert_multi (mrope.c:258-345).

One round inserts the d-th symbol (from the end) of every active read.  The
reference walks six B+-trees run by run with progressive coordinates; here a
round is a fixed dataflow of vectorized primitives:

  1. stable counting sort of read states by destination partition ("bucket")
  2. group detection (runs of equal interval-u within a bucket — the
     `a[k].u != a[k-1].u` grouping of mrope.c:192)
  3. two batched 6-symbol rank queries per group (rope_rank2a equivalent)
  4. closed-form per-group insertion-point arithmetic in START-OF-ROUND
     coordinates (the paper's Algorithm 2/3 arithmetic, mrope.c:204-224, made
     order-free: X_s = L + sum of interval symbol counts that sort before s
     in the insertion order $,A,C,G,T,N — or $,T,G,C,A,N for RCLO)
  5. one coalesced merge pass applying every insertion at once
  6. interval update l' = TL[s] + P[s] + AC[s] folding in the cross-bucket
     rebase (mrope.c:332-340): P = same-partition insertions by earlier
     groups, AC = counts (incl. this round) of s in lower partitions.

Correctness of the start-of-round coordinate transform relies on the
invariants of the reference algorithm: within a bucket, group intervals are
pairwise disjoint and non-decreasing, interval contents are sorted in the
insertion order (the RLO/RCLO sortedness property; for IO all intervals are
empty), and insertions of earlier groups land at positions <= later groups'
intervals.  Tie order is tracked explicitly per insertion.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import NSYM
from ..oracle import SO_IO, SO_RCLO, SO_RLO
from ..index.flat import FlatBwt, empty_state, grow_state
from ..index.merge import apply_insertions
from ..index.merge_gpu import merge_flat, merge_kernel_applies
from ..index.pending import (
    empty_pending,
    pending_add,
    pending_cap,
    pending_flush_args,
    rank_virtual_base,
    rank_virtual2_base,
    reset_pending,
)
from ..index.rank import build_block_tables, rank_global
from ..index.scan import _EXACT, cumsum_small


def _gdt_of(state, pdt):
    """dtype for GLOBAL positions/counts: int64 once the capacity leaves
    int32, regardless of the (partition-local) interval dtype pdt."""
    return I64 if state.cap >= (1 << 31) else pdt


def _state_rank_fn(state, K, gdt):
    """rank_fn(gpos) -> (M, 6) in the GLOBAL dtype, for any state
    representation (int8 flat, 4-bit packed, or run-length)."""
    from ..index.packed import PackedFlatBwt, rank_global_packed
    from ..index.runs import RunBwt, rank_global_runs

    if isinstance(state, RunBwt):
        return lambda g: rank_global_runs(
            state.rend, state.rsym, state.bstart, state.bocc, g
        ).astype(gdt)
    if isinstance(state, PackedFlatBwt):
        return lambda g: rank_global_packed(
            state.pbwt, state.blkA, state.blkB, g
        ).astype(gdt)
    return lambda g: rank_global(state.bwt, state.blk_prefix, g, K)


def _state_rank2_fn(state, K, gdt):
    """Fused two-point rank (precondition: widths <= K) or None for the
    two-call fallback.  Implemented for the int8 flat tier (the bench/
    scale throughput path); other tiers fall back."""
    from ..index.rank import rank2_global

    # DEFAULT OFF: at the 47x-coverage scale shapes the width<=128 regime
    # fires too rarely under a batch-max predicate to amortize the fused
    # branch's extra compute (HACKING.md).  Env-gated for future
    # per-query-masked variants.
    if os.environ.get("ROPEBWT2_TPU_RANK2", "0") == "0":
        return None
    if isinstance(state, FlatBwt):
        # rank2_global returns blk_prefix's dtype — the SAME dtype the
        # single-point rank_fn returns (no cast), so the three width-cond
        # branches of plan_round agree
        return lambda gl, gu: rank2_global(
            state.bwt, state.blk_prefix, gl, gu, K
        )
    return None


def _state_merge(state, gX, sym, stream, active, n, K):
    """Apply one round's insertions to either state representation.
    Returns the updated buffer/table fields as a partial state (dict)."""
    from ..index.packed import (
        PackedFlatBwt,
        apply_insertions_packed,
        build_two_level_tables,
    )
    from ..index.runs import RunBwt, apply_insertions_runs

    if isinstance(state, RunBwt):
        return apply_insertions_runs(state, gX, sym, stream, active)
    if isinstance(state, PackedFlatBwt):
        pbwt = apply_insertions_packed(state.pbwt, n, gX, sym, stream, active)
        blkA, blkB = build_two_level_tables(pbwt, state.cap)
        return dict(pbwt=pbwt, blkA=blkA, blkB=blkB)
    if merge_kernel_applies(state.cap, K):
        new_bwt, new_blk = merge_flat(
            state.bwt, n, gX, sym, stream, active, K=K,
            dtype=state.blk_prefix.dtype,
        )
    else:
        new_bwt = apply_insertions(state.bwt, n, gX, sym, stream, active)
        new_blk = build_block_tables(
            new_bwt, K, dtype=state.blk_prefix.dtype
        )
    return dict(bwt=new_bwt, blk_prefix=new_blk)


I64 = jnp.int64
I32 = jnp.int32
_CAP_ALIGN = 1 << 20  # upfront-capacity rounding (symbols)
# c_flush / c_pend for the auto defer depth (TpuBwt._choose_defer): flush
# time per capacity symbol over pending_add time per pending row, measured
# by scripts/measure_merge.py at cap 2^30 half full on an H100 (400 W
# limit), for the GPU merge kernel and for the plain XLA merge (the other
# tiers, the sharded engine and the CPU).
FLUSH_PER_PEND_KERNEL = 0.0175
FLUSH_PER_PEND_PLAIN = 0.13
_EM_EINSUM_MAX = 1 << 21  # f32 exactness bound for the Wc/We contraction


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ReadStates:
    """Per-read BCR state (the reference's triple64_t, mrope.c:174-178).
    Maintained in 'array order', re-permuted by the bucket sort each round.

    The read's buffer offset and last-inserted symbol are PACKED into one
    word ``pk = (off // 8) << 3 | c`` — read starts are 8-aligned in the
    NUL-terminated sequence buffer, so three M-sized permutes (l, u, pk)
    move the whole state each round instead of five.  pk < 0 marks padding
    rows (they stay inert at the array front).  Read lengths are implicit:
    the buffer stores a 0 terminator after each read, so the terminator
    round inserts the sentinel and flips c to 0, which retires the row."""

    l: jax.Array  # int[M] interval lower bound, local to partition c
    u: jax.Array  # int[M] interval upper bound
    pk: jax.Array  # int32[M] (int64 for >1 GB buffers) packed (off//8)<<3|c


def onehot_rows(ohf, table):
    """rows[m] = table[c[m]] for an (M, 6) f32 one-hot ``ohf`` of c and an
    int32 (6, S) table, as two exact f32 contractions (values < 2^31 split
    12 low / 19 high bits; one-hot selection keeps each product exact)
    instead of six (M, S)-wide select passes.

    precision=HIGHEST is MANDATORY: a default-precision f32 dot may round
    its operands (TF32 on the GPU), which breaks integers above 2^11 (see
    index/scan.py)."""
    lo = jnp.einsum(
        "mb,bs->ms", ohf, (table & 0xFFF).astype(jnp.float32),
        precision=_EXACT,
    )
    hi = jnp.einsum(
        "mb,bs->ms", ohf, (table >> 12).astype(jnp.float32),
        precision=_EXACT,
    )
    return (hi.astype(I32) << 12) + lo.astype(I32)


def _insertion_order(so):
    """Symbol emission order within a group: $ first, then A..T (or T..A for
    RCLO), then N (mrope.c:206-224). Returns em[s] = emission rank of s."""
    mid = (4, 3, 2, 1) if so == SO_RCLO else (1, 2, 3, 4)
    em = [0] * NSYM
    em[0] = 0
    for i, s in enumerate(mid):
        em[s] = i + 1
    em[5] = 5
    return tuple(em)


def plan_round(psize, pcounts, reads: ReadStates, buf, d, is_first,
               rank_fn, *, so, comm=None, gdt=None, rank2_fn=None):
    """Steps 1-4 + interval updates of one BCR round, independent of how the
    flat buffer is stored: ``rank_fn(gpos) -> (M, 6)`` supplies GLOBAL
    6-symbol ranks (single-device table lookup, or routed shard lookups).

    Position arithmetic runs in the dtype of reads.l (int32 when the
    capacity fits, which halves the bytes of every M-wide pass; the driver
    picks the dtype).

    ``comm`` abstracts the handful of global primitives (scans, the sort
    permutation, boundary rolls, reductions) so the same algorithm runs
    single-device (LocalComm, the default — ops identical to the tuned
    single-chip path) or sharded under shard_map (ShardComm): reads here
    means the LOCAL block of the read state.

    Returns (new_reads, gX, sym, stream, active, ins_bucket, n_ins)."""
    if comm is None:
        from ..parallel.comm import LocalComm

        comm = LocalComm()
    M = reads.l.shape[0]  # local rows
    Mg = M * getattr(comm, "d", 1)  # global rows (exactness thresholds)
    pdt = reads.l.dtype
    # gdt = dtype of GLOBAL positions/counts (rank query points, gX, the
    # partition-offset/prefix tables).  Stored intervals l/u are
    # PARTITION-LOCAL (< max partition size), so above 2^31 total symbols
    # the driver keeps l/u int32 (pdt) while only the few global
    # touchpoints run int64 (gdt), so the M-wide passes stay 32-bit.
    if gdt is None:
        gdt = pdt
    em = jnp.asarray(_insertion_order(so), dtype=I32)
    arange_m = comm.iota(M)  # GLOBAL row index of each local row
    ar6 = jnp.arange(NSYM, dtype=I32)

    # ---- 1. stable counting sort by bucket (mrope.c:303-310) ----
    # Gather-free formulation: every "x[idx]" over M rows is either a
    # one-hot contraction (6-wide lookups) or a blocked prefix-scan
    # propagation (head/tail lookups), so the M-wide data movement is
    # streaming select/scan passes rather than random-access gathers.
    pk0 = reads.pk
    dead0 = pk0 < 0
    c0 = (pk0 & 7).astype(I32)  # 7 on padding rows
    key = jnp.where(dead0, 0, c0)
    onehot_key = (key[:, None] == ar6[None, :]).astype(I32)
    csum_key, totals = comm.cumsum_with_totals(onehot_key)
    base = jnp.concatenate([jnp.zeros(1, I32), cumsum_small(totals)[:-1]])
    dest = (
        jnp.sum(base[None, :] * onehot_key, axis=1, dtype=I32)
        + jnp.sum(csum_key * onehot_key, axis=1, dtype=I32)
        - 1
    )
    # move the payload (dest is a global permutation: direct scatters on
    # one device, a balanced all-to-all re-shard otherwise)
    l, u, pk = comm.permute(dest, (reads.l, reads.u, pk0))
    dead = pk < 0
    c = (pk & 7).astype(I32)

    # done: the sentinel was inserted in an earlier round (bucket 0). In the
    # very first round every real read is active with c == 0 (the first
    # column goes to partition 0, mrope.c:279-285).
    inert = dead | (jnp.logical_not(is_first) & (c == 0))
    active = jnp.logical_not(inert)

    # ---- next symbol of each read (reads are stored reversed) ----
    # buffer offsets are 8-aligned; the 0 terminator after each read makes
    # the sentinel round implicit (and inert rows mask to 0 anyway).
    # comm.fetch_syms: direct gather single-device; a routed exchange when
    # the read buffer is sharded by byte range (no full replication)
    off = (pk >> 3) * 8
    sym = comm.fetch_syms(buf, off + d)
    sym = jnp.where(active, sym, 0)
    ohp = (sym[:, None] == ar6[None, :])  # (M,6) one-hot of sym

    def take_sym(t):  # t[:, sym] without a gather
        return jnp.sum(t * ohp.astype(t.dtype), axis=1, dtype=t.dtype)

    # ---- 2. groups: runs of equal (inert, bucket, u) ----
    tkey = c * 2 + inert.astype(I32)  # bucket + inert packed: one compare
    prev_tkey = comm.roll1(tkey)
    prev_u = comm.roll1(u)
    bucket_head = (arange_m == 0) | (tkey != prev_tkey)
    head = bucket_head | (u != prev_u)
    # one stacked scan for both head-index propagations (scan passes, not
    # widths, dominate the cost of these blocked prefix ops)
    hh = comm.cummax(
        jnp.stack(
            [
                jnp.where(head, arange_m, 0),
                jnp.where(bucket_head, arange_m, 0),
            ],
            axis=1,
        )
    )
    headidx, bktheadidx = hh[:, 0], hh[:, 1]

    # Stored intervals are in PROGRESSIVE coordinates (the reference inserts
    # group by group; a group's stored position already counts every
    # insertion made into its partition by earlier groups of the same round,
    # all of which land before it).  E = #reads in earlier groups of this
    # bucket recovers start-of-round coordinates, in which the old buffer
    # and its rank tables live.  Group members share the same stored l and
    # u (the reference writes identical tl[c]/tu[c] to every member,
    # mrope.c:227-231, and distinct parent groups' children cannot collide
    # on u within a bucket), so the head subtraction is elementwise — no
    # gather needed.
    E = (headidx - bktheadidx).astype(pdt)
    L = l - E
    U = u - E

    # ---- 3. batched rank2a at the group interval ends ----
    poff = jnp.concatenate(
        [jnp.zeros(1, I64), cumsum_small(psize)[:-1]]
    ).astype(gdt)  # partition offsets (GLOBAL values)
    pprefix = jnp.concatenate(
        [
            jnp.zeros((1, NSYM), I64),
            cumsum_small(pcounts, axis=0)[:-1],
        ]
    ).astype(gdt)  # pprefix[b, s] = count of s in partitions < b
    ohc = c[:, None] == ar6[None, :]
    if gdt == I32:
        ohf = ohc.astype(jnp.float32)

        def sel_rows(table):  # table (6, S) int32 -> (M, S) rows[c]
            return onehot_rows(ohf, table)

        sel = sel_rows(
            jnp.concatenate([pprefix, poff[:, None]], axis=1)
        )
        pprefix_c, poc = sel[:, :NSYM], sel[:, NSYM]
    else:

        def sel_rows(table):  # select-pass path: exact at any size/dtype
            out = jnp.zeros((M, table.shape[1]), gdt)
            for b in range(NSYM):
                out = jnp.where((c == b)[:, None], table[b][None, :], out)
            return out

        poc = jnp.sum(jnp.where(ohc, poff[None, :], 0), axis=1, dtype=gdt)
        pprefix_c = sel_rows(pprefix)
    gLq = poc + L  # promotes to gdt
    if so == SO_IO:
        # input order keeps every interval empty (l == u by induction:
        # mr_insert1's l==u path and singleton groups) — skip the second
        # rank query, delta is identically zero
        TL = (rank_fn(gLq) - pprefix_c).astype(pdt)
        delta = jnp.zeros_like(TL)
    else:
        # Interval widths start at the PREVIOUS string count and shrink
        # ~4x per round (reads sharing a suffix), hitting zero after
        # ~log4 rounds — from then on the U-end rank is identically the
        # L-end rank.  Three width regimes, selected by ONE comm-reduced
        # predicate (SPMD-safe under shard_map):
        #   wmax == 0   skip the U-end rank entirely (all of a first
        #               batch; most uniform-data sustained rounds);
        #   wmax <= 128 FUSED two-point rank: both ends from one paired
        #               row gather (rank2_fn) — the common coverage-data
        #               regime, where shared suffixes keep intervals
        #               non-empty for most of the read length;
        #   else        two independent rank calls (early rounds).
        # widths are partition-local and exact in pdt; clamp before the
        # int32 cast so only the {0, <=128, >128} classification survives
        gUq = poc + U
        if os.environ.get("ROPEBWT2_TPU_WIDTH3", "1") == "0":
            # r04 two-regime structure (bisection / fallback): skip the
            # U rank when all widths are zero, else two full calls
            TLr = rank_fn(gLq)
            wnz = comm.max_scalar(
                jnp.where(active, (U != L).astype(I32), 0)
            )
            delta = jax.lax.cond(
                wnz == 0,
                lambda: jnp.zeros_like(TLr),
                lambda: rank_fn(gUq) - TLr,
            ).astype(pdt)
            TL = (TLr - pprefix_c).astype(pdt)
        else:
            wmax = comm.max_scalar(
                jnp.where(
                    active,
                    jnp.minimum(U - L, jnp.asarray(1 << 20, pdt)),
                    jnp.zeros((), pdt),
                ).astype(I32)
            )
            if rank2_fn is None:
                def rank2_fn(a, b):  # fallback: two independent calls
                    return rank_fn(a), rank_fn(b)

            def only_l():
                TLr = rank_fn(gLq)
                return TLr, jnp.zeros_like(TLr)

            def fused():
                ol, ou = rank2_fn(gLq, gUq)
                return ol, ou - ol

            def separate():
                TLr = rank_fn(gLq)
                return TLr, rank_fn(gUq) - TLr

            TLr, delta = jax.lax.cond(
                wmax == 0,
                only_l,
                lambda: jax.lax.cond(wmax <= 128, fused, separate),
            )
            delta = delta.astype(pdt)
            TL = (TLr - pprefix_c).astype(pdt)

    # ---- 4. insertion points per symbol, start-of-round local coords ----
    # X[:, s] = L + sum of delta over symbols emitted before s.
    order = [0] + ([4, 3, 2, 1] if so == SO_RCLO else [1, 2, 3, 4]) + [5]
    xcols = [None] * NSYM
    running = L
    for s in order:
        xcols[s] = running
        running = running + delta[:, s]
    X = jnp.stack(xcols, axis=1)  # (M,6)

    gX = poc + take_sym(X)  # global old-coord insertion point per read

    # ---- per-row / per-group combinatorics ----
    oh = ohp & active[:, None]
    oh32 = oh.astype(I32)
    csum = comm.cumsum(oh32)  # inclusive
    excl = csum - oh32

    # head/bucket-head values of the non-decreasing count columns,
    # propagated to every row by a blocked prefix-max (row 0 is always a
    # head, and the columns are >= 0, so a 0 fill is the identity).  All
    # forward head-propagations ride ONE stacked scan — pass count, not
    # width, dominates blocked-scan cost.
    # before_in_group = sum_s (csum[tail,s] - excl[head,s]) * em_lt[sym,s]:
    # precontract the 6-wide axis as an f32 dot (exact while M < 2^21),
    # then propagate tail values backward with a reverse prefix-min (the
    # columns are non-decreasing and the last row is always a tail)
    em_tup = _insertion_order(so)  # static python tuple
    is_tail = comm.shift_up1_bool(head, True)
    if Mg <= _EM_EINSUM_MAX:
        # f32 values stay < 5 * 2^21 < 2^24: exact at HIGHEST precision
        em_lt = (em[None, :] < em[:, None]).astype(I32)
        emf = em_lt.astype(jnp.float32)
        Wc = jnp.einsum(
            "ms,ts->mt", csum.astype(jnp.float32), emf, precision=_EXACT
        ).astype(I32)
        We = jnp.einsum(
            "ms,ts->mt", excl.astype(jnp.float32), emf, precision=_EXACT
        ).astype(I32)
    else:
        # static-mask integer contraction: out[:, t] = sum over the
        # (static) symbols emitted before t — <= 15 column adds, exact at
        # any size
        def emlt_dot(x):
            cols = []
            for t in range(NSYM):
                sel = [sidx for sidx in range(NSYM)
                       if em_tup[sidx] < em_tup[t]]
                acc = jnp.zeros((M,), I32)
                for sidx in sel:
                    acc = acc + x[:, sidx]
                cols.append(acc)
            return jnp.stack(cols, axis=1)

        Wc = emlt_dot(csum)
        We = emlt_dot(excl)
    fwd = comm.cummax(
        jnp.concatenate(
            [
                jnp.where(head[:, None], excl, 0),
                jnp.where(bucket_head[:, None], excl, 0),
                jnp.where(head[:, None], We, 0),
            ],
            axis=1,
        )
    )
    head_excl, bkt_excl = fwd[:, :NSYM], fwd[:, NSYM : 2 * NSYM]
    We_head = fwd[:, 2 * NSYM :]
    Wc_tail = comm.cummin_rev(
        jnp.where(is_tail[:, None], Wc, jnp.iinfo(I32).max)
    )
    before_in_group = take_sym(Wc_tail - We_head)
    # my-symbol insertions by earlier groups of my bucket
    P_sym = take_sym(head_excl - bkt_excl).astype(pdt)

    # per-bucket inserted-symbol totals: a 6xM one-hot contraction
    # instead of a scatter-add into 6 segments
    if M <= (1 << 24):  # f32 accumulation exact up to 2^24 (local rows)
        bucket_oh = ohc.T & active[None, :]
        ins_bucket = comm.psum_array(jnp.einsum(
            "bm,ms->bs",
            bucket_oh.astype(jnp.float32),
            oh32.astype(jnp.float32),
            precision=_EXACT,
        ).astype(I64))
    else:
        ins_bucket = comm.psum_array(jax.ops.segment_sum(
            oh32, jnp.where(active, c, NSYM - 1), num_segments=NSYM
        ).astype(I64))
    ac_excl = jnp.concatenate(
        [
            jnp.zeros((1, NSYM), I64),
            cumsum_small(pcounts + ins_bucket, axis=0)[:-1],
        ]
    ).astype(gdt)  # (6,6): counts of s in partitions < b after this round

    # ---- global tie rank (stream index) of each read's insertion ----
    rank_in_run = take_sym(excl - head_excl)
    n_inert = comm.sum_scalar(inert, I32)
    stream = (
        (headidx - n_inert).astype(pdt)
        + before_in_group.astype(pdt)
        + rank_in_run.astype(pdt)
    )

    # ---- interval update (+ fused cross-bucket rebase) ----
    # the updated interval is PARTITION-LOCAL (< the new partition's
    # size), so active rows' values fit pdt even when the rebase table
    # holds larger (gdt) counts; inactive rows keep their old value
    ac_c = sel_rows(ac_excl)
    l_new = take_sym(TL).astype(gdt) + P_sym.astype(gdt) + take_sym(ac_c)
    u_new = l_new + take_sym(delta).astype(gdt)
    l = jnp.where(active, l_new.astype(pdt), l)
    u = jnp.where(active, u_new.astype(pdt), u)
    # fold the inserted symbol into the packed word (pk & -8 keeps off<<3)
    pk = jnp.where(active, (pk & ~jnp.asarray(7, pk.dtype)) | sym.astype(pk.dtype), pk)

    n_ins = comm.sum_scalar(active, I64)
    new_reads = ReadStates(l=l, u=u, pk=pk)
    return new_reads, gX, sym, stream, active, ins_bucket, n_ins


def bcr_round_impl(state, reads: ReadStates, buf, d, is_first, *, K, so):
    """One BCR round: insert the d-th (from read end) symbol of every active
    read. Returns (new_state, new_reads, n_inserted).  ``state`` is either
    a FlatBwt or a PackedFlatBwt (capacity mode)."""
    gdt = _gdt_of(state, reads.l.dtype)
    rank_fn = _state_rank_fn(state, K, gdt)
    new_reads, gX, sym, stream, active, ins_bucket, n_ins = plan_round(
        state.psize, state.pcounts, reads, buf, d, is_first, rank_fn,
        so=so, gdt=gdt, rank2_fn=_state_rank2_fn(state, K, gdt),
    )
    # ---- merge (+ fused rank-table rebuild on the GPU kernel path) ----
    merged = _state_merge(state, gX, sym, stream, active, state.n, K)
    new_state = dataclasses.replace(
        state,
        n=state.n + n_ins,
        psize=state.psize + jnp.sum(ins_bucket, axis=1),
        pcounts=state.pcounts + ins_bucket,
        **merged,
    )
    return new_state, new_reads, n_ins


bcr_round = functools.partial(
    jax.jit, static_argnames=("K", "so"), donate_argnums=(0, 1)
)(bcr_round_impl)


def _flush_pending(st, pend, *, K):
    """Apply the whole pending set to the base buffer in one merge pass
    and reset the pending index.  st.n/psize/pcounts already reflect the
    virtual totals (updated per round); only the buffer and its rank
    tables change.  Works on either state representation."""
    pos, sym, stream, valid = pending_flush_args(pend)
    n_base = st.n - pend.p.astype(st.n.dtype)
    merged = _state_merge(st, pos, sym, stream, valid, n_base, K)
    return dataclasses.replace(st, **merged), reset_pending(pend)


def bcr_batch_deferred_impl(state, reads, buf, n_rounds, *, K, so, defer_r,
                            pcap, d_lo=None):
    """Run all rounds of one batch with multi-round insertion buffering:
    the base buffer is frozen for ``defer_r`` rounds while insertions
    accumulate in a sorted pending side index (index/pending.py); rank
    queries are answered from base + pending; one coalesced merge flushes
    the set every defer_r rounds.  Cuts the O(live prefix)-per-round merge
    traffic by defer_r — the flat-layout answer to the reference rope's
    O(log n)/symbol insertion economics (/root/reference/rope.c:114-148).

    ``pcap`` must be >= defer_r * (max insertions per round).  ``d_lo``
    (round-range chunking) must be a multiple of defer_r — chunk
    boundaries then coincide with flushes and the pending set starts each
    chunk empty."""
    nr = n_rounds.astype(I32)
    s_lo = (
        jnp.zeros((), I32) if d_lo is None else d_lo.astype(I32) // defer_r
    )
    gdt = _gdt_of(state, reads.l.dtype)
    pend0 = empty_pending(pcap, gdt)  # vp holds GLOBAL virtual positions

    def outer(sidx, carry):
        st, rd, pend = carry
        # base buffer + tables frozen through the inner loop
        base_fn = _state_rank_fn(st, K, gdt)
        base2_fn = _state_rank2_fn(st, K, gdt)
        lo = sidx * defer_r

        def inner(d, c):
            (n, psize, pcounts), rd, pend = c
            rank_fn = lambda g: rank_virtual_base(base_fn, pend, g)  # noqa: E731
            rank2_fn = None
            if base2_fn is not None:
                rank2_fn = lambda gl, gu: rank_virtual2_base(  # noqa: E731
                    base2_fn, pend, gl, gu
                )
            new_rd, gX, sym, stream, active, ins_bucket, n_ins = plan_round(
                psize, pcounts, rd, buf, d.astype(I32), d == 0, rank_fn,
                so=so, gdt=gdt, rank2_fn=rank2_fn,
            )
            pend = pending_add(pend, gX, sym, stream, active)
            return (
                (n + n_ins, psize + jnp.sum(ins_bucket, axis=1),
                 pcounts + ins_bucket),
                new_rd,
                pend,
            )

        (n, psize, pcounts), rd, pend = jax.lax.fori_loop(
            lo, jnp.minimum(lo + defer_r, nr), inner,
            ((st.n, st.psize, st.pcounts), rd, pend),
        )
        st = dataclasses.replace(st, n=n, psize=psize, pcounts=pcounts)
        st, pend = _flush_pending(st, pend, K=K)
        return st, rd, pend

    n_super = (nr + defer_r - 1) // defer_r
    st, rd, _ = jax.lax.fori_loop(
        s_lo, n_super, outer, (state, reads, pend0)
    )
    return st, rd


def bcr_batch_range_impl(state, reads, buf, d_lo, d_hi, *, K, so,
                         defer_r=0, pcap=0):
    """Run rounds [d_lo, d_hi) of a batch in one compiled call.  Kilobase+
    reads mean tens of thousands of rounds, so the driver splits long
    batches into round ranges and no single dispatch runs for minutes
    (state + read state stay on device between dispatches; d_lo must be a
    multiple of defer_r so chunk boundaries coincide with pending
    flushes)."""
    if defer_r > 0:
        return bcr_batch_deferred_impl(
            state, reads, buf, d_hi, K=K, so=so, defer_r=defer_r,
            pcap=pcap, d_lo=d_lo,
        )

    def body(d, carry):
        st, rd = carry
        st, rd, _ = bcr_round_impl(
            st, rd, buf, d.astype(I32), d == 0, K=K, so=so
        )
        return st, rd

    return jax.lax.fori_loop(d_lo, d_hi, body, (state, reads))


def bcr_batch_impl(state, reads, buf, n_rounds, *, K, so, defer_r=0,
                   pcap=0):
    """Run all rounds of one batch inside a single compiled call — one
    device dispatch per batch instead of one per symbol column.  With
    defer_r > 0, route through the deferred-merge loop (see
    bcr_batch_deferred_impl)."""
    return bcr_batch_range_impl(
        state, reads, buf, jnp.zeros((), I64), n_rounds, K=K, so=so,
        defer_r=defer_r, pcap=pcap,
    )


bcr_batch = functools.partial(
    jax.jit, static_argnames=("K", "so", "defer_r", "pcap"),
    donate_argnums=(0, 1),
)(bcr_batch_impl)

bcr_batch_range = functools.partial(
    jax.jit, static_argnames=("K", "so", "defer_r", "pcap"),
    donate_argnums=(0, 1),
)(bcr_batch_range_impl)


def bcr_batch_packed_impl(state, meta, pbuf, *, K, so, mpad, defer_r=0,
                          pcap=0):
    """bcr_batch with less host->device traffic: the read buffer arrives
    nibble-packed (two nt6 symbols per byte) and the whole read state plus
    the round count ride ONE int32 array ``meta = [n_rounds, l, u, pk]``."""
    n_rounds = meta[0].astype(I64)
    reads = ReadStates(
        l=meta[1 : 1 + mpad],
        u=meta[1 + mpad : 1 + 2 * mpad],
        pk=meta[1 + 2 * mpad : 1 + 3 * mpad],
    )
    # unpack nibbles PLANE-WISE: high nibbles hold buf[:half], low nibbles
    # buf[half:], so the unpack is a full-width concat with no (N, 2)-shaped
    # intermediate
    buf = jnp.concatenate([pbuf >> 4, pbuf & 0xF])
    return bcr_batch_impl(state, reads, buf, n_rounds, K=K, so=so,
                          defer_r=defer_r, pcap=pcap)


bcr_batch_packed = functools.partial(
    jax.jit, static_argnames=("K", "so", "mpad", "defer_r", "pcap"),
    donate_argnums=(0,),
)(bcr_batch_packed_impl)


def bcr_batch_uniform_impl(state, blob, *, K, so, mpad, L, stride,
                           defer_r=0, pcap=0):
    """Minimum-transfer path for uniform-length ACGT-only batches (the
    dominant short-read shape): the ONLY per-batch host->device transfer is
    ``blob`` = 2-bit-packed read matrix (4 symbols/byte, reversed, code-1)
    followed by 16 bytes of scalars [m, n_sent_lo, n_sent_hi, unused] as
    little-endian int32.  Read state (l, u, pk) is derived on device from
    iotas, so a batch ships a quarter byte per symbol and no state arrays."""
    scal = blob[mpad * (stride // 4) :].astype(I32)

    def le32(o):
        return (
            scal[o]
            | (scal[o + 1] << 8)
            | (scal[o + 2] << 16)
            | (scal[o + 3] << 24)
        )

    m = le32(0)
    n_sent = le32(4)  # < 2^31 when int32 positions apply
    packed = blob[: mpad * (stride // 4)].reshape(mpad, stride // 4)

    # unpack 2-bit codes -> the stride-aligned nt6 buffer layout.  The host
    # packs COLUMN-BLOCKED (byte j holds columns j, j+stride/4, j+stride/2,
    # j+3*stride/4) so the unpack is four full-width planes concatenated,
    # with no (N, 4)-shaped intermediate.  Columns >= L become 0 (the read
    # terminator); padding rows are never read.
    quads = jnp.concatenate(
        [
            (packed >> 6) & 3,
            (packed >> 4) & 3,
            (packed >> 2) & 3,
            packed & 3,
        ],
        axis=1,
    )
    col = jax.lax.broadcasted_iota(I32, (mpad, stride), 1)
    buf = jnp.where(col < L, quads.astype(jnp.int8) + 1, 0).reshape(-1)

    i = jnp.arange(mpad, dtype=I32)
    npad = mpad - m
    real = i >= npad
    pk = jnp.where(real, (i - npad) * stride, -1)  # 8-aligned offsets
    if so == SO_IO:
        l = jnp.where(real, n_sent + (i - npad), 0)
        u = l
    else:
        l = jnp.zeros(mpad, I32)
        u = jnp.where(real, n_sent, 0)
    reads = ReadStates(l=l, u=u, pk=pk)
    return bcr_batch_impl(state, reads, buf, jnp.asarray(L + 1, I64), K=K,
                          so=so, defer_r=defer_r, pcap=pcap)


bcr_batch_uniform = functools.partial(
    jax.jit,
    static_argnames=("K", "so", "mpad", "L", "stride", "defer_r", "pcap"),
    donate_argnums=(0,),
)(bcr_batch_uniform_impl)


def _round_up(x, m):
    return -(-x // m) * m


def _pad_pow2(x, lo=16):
    n = lo
    while n < x:
        n *= 2
    return n


class TpuBwt:
    """Host-side driver: the mrope_t equivalent.

    Capabilities: batched insertion (mr_insert_multi), single-string insertion
    (insert1, via one-read batches), incremental growth across batches, and
    export of the BWT / runs for the output formats."""

    def __init__(self, so=SO_IO, K=128, defer_r=None):
        # K=128: a rank query counts at most 128 in-block symbols
        assert so in (SO_IO, SO_RLO, SO_RCLO)
        self.so = so
        self.K = K
        self.state = empty_state(K, K)
        # host-side mirrors: never read device scalars in the hot path (a
        # blocking device->host scalar pull stalls the dispatch queue)
        self._n = 0  # total symbols
        self._n_strings = 0  # total strings (== sentinel count)
        # deferred-merge depth: -1 = auto (scale R with live-prefix/batch
        # ratio), 0 = merge every round, >0 = fixed R
        if defer_r is None:
            defer_r = int(os.environ.get("ROPEBWT2_TPU_DEFER_R", "-1"))
        self._defer_cfg = defer_r
        # run-tier slot bound: every insertion adds at most 2 slots (one
        # split item + one tail piece), so the driver can plan capacity
        # without device syncs; tightened by an nslot pull when a growth
        # decision is near (see _plan)
        self._nslot_bound = 0

    def _choose_defer(self, mpad):
        """(defer_r, pcap) for the next batch.  Auto mode balances the two
        per-round costs: full-prefix merge ~ cap * c_merge / R against
        pending-side vector work ~ R * mpad * c_pend, giving
        R* = sqrt((c_merge/c_pend) * cap / mpad).

        Keyed on the CAPACITY, not the live n: capacity is already a static
        compile key (growing it re-jits the batch program regardless), so
        every batch of a preallocated run shares ONE (defer_r, pcap) and
        compiles once (keying on self._n re-jits the batch program whenever
        the power-of-two R changes).  The plain flush walks the whole
        allocation, so cap is also the more faithful cost input; the GPU
        kernel's cost per capacity symbol is taken at half occupancy."""
        if self._defer_cfg >= 0:
            r = self._defer_cfg
        else:
            import math

            # The run tier's flush walks rcap SLOTS of ~5 bytes (vs 1-byte
            # symbols): substitute 5*rcap as the cap-equivalent cost input.
            cap_eq = (
                5 * self.state.rcap
                if hasattr(self.state, "rcap") else self.state.cap
            )
            kernel = isinstance(self.state, FlatBwt) and merge_kernel_applies(
                self.state.cap, self.K)
            c = FLUSH_PER_PEND_KERNEL if kernel else FLUSH_PER_PEND_PLAIN
            ratio = c * cap_eq / max(mpad, 1)
            r = int(math.sqrt(ratio)) if ratio >= 1 else 0
            if r < 4:
                # shallow deferral loses: the pending machinery's fixed
                # per-round cost (table rebuild, descents) isn't amortized
                r = 0
            else:
                r = 1 << min(6, (r - 1).bit_length())  # pow2 >= r, <= 64
        if r <= 1:
            return 0, 0
        return r, pending_cap(mpad, r)

    # --- capacity planning ---

    @staticmethod
    def _pack_threshold():
        """Symbols above which the index switches to 4-bit packed storage
        (index/packed.py).  'auto' = 2^31 (where int8 storage stops
        fitting the worm-scale memory budget and positions leave int32
        anyway); '0' disables; any integer = explicit threshold."""
        v = os.environ.get("ROPEBWT2_TPU_PACK4", "auto")
        if v == "0":
            return None
        if v == "auto":
            return 1 << 31
        return int(v)

    @staticmethod
    def _runs_threshold():
        """Symbols above which the index switches to the run-length
        compressed tier (index/runs.py) — the O(runs) memory/merge mode
        for coverage-shaped data.  Unset/'0' disables; '1' = from the
        start; any integer = explicit threshold."""
        v = os.environ.get("ROPEBWT2_TPU_RUNS", "0")
        if v == "0":
            return None
        return int(v)

    def _to_runs(self, total_bound: int):
        """Convert the current state to the run tier (host round-trip:
        conversion happens once, at a small n by construction — _plan
        switches as soon as the PLANNED total crosses the threshold)."""
        from ..index.runs import (
            RCAP_ALIGN, RUN_LEN_MAX, runs_from_arrays,
        )

        bwt = self.bwt_array()
        n = bwt.shape[0]
        if n:
            change = np.flatnonzero(np.diff(bwt)) + 1
            starts = np.concatenate([[0], change])
            ends = np.concatenate([change, [n]])
            syms = bwt[starts]
            lens = (ends - starts).astype(np.int64)
            if (lens >= RUN_LEN_MAX).any():  # split over-long runs
                half = RUN_LEN_MAX // 2
                reps = -(-lens // half)
                syms = np.repeat(syms, reps)
                rem = np.repeat(lens - (reps - 1) * half, reps)
                iwi = np.arange(len(syms)) - np.repeat(
                    np.cumsum(reps) - reps, reps
                )
                lens = np.where(iwi == reps.repeat(reps) - 1, rem, half)
        else:
            syms = np.zeros(0, np.int8)
            lens = np.zeros(0, np.int64)
        self._nslot_bound = len(syms)
        from ..index.runs import RUNS_BIG, RUNS_CHUNK

        rcap = _round_up(
            len(syms) + max(len(syms) // 4, RCAP_ALIGN), RCAP_ALIGN
        )
        if rcap >= RUNS_BIG:
            rcap = _round_up(rcap, RUNS_CHUNK)
        self.state = runs_from_arrays(
            syms, lens, rcap, total_bound, self._n,
            np.asarray(self.state.psize), np.asarray(self.state.pcounts),
        )

    @staticmethod
    def _runs_margin() -> float:
        """Slot-growth factor per inserted symbol used for run-tier
        capacity planning.  2.0 is the worst-case bound (every insertion
        an isolated split: one new-symbol item + one tail piece) and
        never overflows.  Lower values (ROPEBWT2_TPU_RUNS_MARGIN) size
        rcap optimistically for compressible (coverage-shaped) data —
        the flush's XLA ladder walks rcap slots, so a tight rcap is also
        a throughput knob; the engine then pulls the true slot count
        after every batch and ABORTS (sticky overflow flag) if a batch
        ever out-grows the allocation."""
        return float(os.environ.get("ROPEBWT2_TPU_RUNS_MARGIN", "2.0"))

    def _post_batch_runs(self, total: int):
        from ..index.runs import RunBwt

        if not isinstance(self.state, RunBwt):
            return
        if self._runs_margin() >= 2.0:
            self._nslot_bound += 2 * total + 1024
        else:
            self._nslot_bound = int(self.state.nslot)
            if int(self.state.overflow):
                raise RuntimeError(
                    "run-tier slot allocation overflowed (raise "
                    "ROPEBWT2_TPU_RUNS_MARGIN); the build is corrupt"
                )

    def _plan_runs(self, need: int, extra: int):
        from ..index.runs import (
            RCAP_ALIGN, RunBwt, gdt_for_symbols, grow_runs_state,
        )

        if not isinstance(self.state, RunBwt):
            self._to_runs(need)
            return
        st = self.state
        if jnp.dtype(gdt_for_symbols(need)).itemsize > st.bstart.dtype.itemsize:
            # table dtype upgrade (planned total left int32): rebuild the
            # block tables in int64 from the resident run arrays
            from ..index.runs import _rebuild_tables
            import dataclasses as _dc

            idxr = jnp.arange(st.rcap, dtype=jnp.int32)
            lens = st.rend - jnp.where(
                idxr % 128 == 0, 0,
                jnp.concatenate([jnp.zeros(1, I32), st.rend[:-1]]),
            )
            rend, bstart, bocc = _rebuild_tables(
                lens, st.rsym, st.nslot, jnp.int64
            )
            st = _dc.replace(st, rend=rend, bstart=bstart, bocc=bocc)
            self.state = st
        # explicit slot preallocation (ROPEBWT2_TPU_RUNS_RCAP): the run
        # count of a build is a data property the driver cannot predict
        # (compressibility), and growing rcap mid-build recompiles the
        # batch program each time — scale drivers size it upfront like
        # the reference's -m sizes its batch
        hint = int(os.environ.get("ROPEBWT2_TPU_RUNS_RCAP", "0"))
        if hint > 0:
            if hint > st.rcap:
                from ..index.runs import RUNS_BIG, RUNS_CHUNK

                rc = _round_up(hint, RCAP_ALIGN)
                if rc >= RUNS_BIG:
                    rc = _round_up(rc, RUNS_CHUNK)
                self.state = grow_runs_state(st, rc)
            return  # operator-managed capacity; overflow flag is the backstop
        f = self._runs_margin()
        # a YOUNG index has no duplicate-suffix structure yet: early
        # batches split nearly every insertion (~2 slots each), so the
        # compressibility margin only applies once the index holds at
        # least a batch worth of slots; the sticky overflow flag remains
        # the correctness backstop either way
        if self._nslot_bound < extra:
            f = max(f, 2.0)
        slots_needed = self._nslot_bound + int(f * extra) + 2048
        if slots_needed > st.rcap:
            # tighten the bound with one scalar pull before growing
            self._nslot_bound = int(st.nslot)
            assert int(st.overflow) == 0, "run-tier envelope breached"
            slots_needed = self._nslot_bound + int(f * extra) + 2048
            if slots_needed > st.rcap:
                from ..index.runs import RUNS_BIG, RUNS_CHUNK

                new_rcap = _round_up(
                    slots_needed + slots_needed // 4, RCAP_ALIGN
                )
                if new_rcap >= RUNS_BIG:
                    # chunked-expand alignment (runs.py gate)
                    new_rcap = _round_up(new_rcap, RUNS_CHUNK)
                self.state = grow_runs_state(st, new_rcap)

    def _plan(self, extra_symbols: int):
        from ..index.packed import (
            PackedFlatBwt,
            grow_packed_state,
            packed_from_flat,
        )
        from ..index.runs import RunBwt

        need = self._n + extra_symbols
        cap = self.state.cap
        rthr = self._runs_threshold()
        if rthr is not None and (
            need > rthr or isinstance(self.state, RunBwt)
        ):
            self._plan_runs(need, extra_symbols)
            return
        thr = self._pack_threshold()
        is_packed = isinstance(self.state, PackedFlatBwt)
        want_packed = thr is not None and (need > thr or is_packed)
        if want_packed:
            assert self.K == 128, "packed mode requires K=128 tables"
            # LINEAR rounding (1 Msym granularity), not pow2: capacity mode
            # runs near the edge of device memory, and pow2 padding wastes
            # up to 2x
            new_cap = cap if need <= cap else _round_up(need, _CAP_ALIGN)
            new_cap = _round_up(new_cap, 256)
            if is_packed:
                if new_cap > cap:
                    self.state = grow_packed_state(self.state, new_cap)
            else:
                if cap % 256:
                    self.state = grow_state(
                        self.state, _round_up(cap, 256), self.K
                    )
                self.state = packed_from_flat(self.state, new_cap)
            return
        if need > cap:
            if need >= 4 * cap and need >= (1 << 24):
                # UPFRONT plan (a caller pre-sizing a whole build):
                # LINEAR rounding, not pow2 — rank-gather locality tracks
                # the ALLOCATION span (the block table covers cap/K rows
                # regardless of n), and pow2 padding up to doubles it.
                # Pow2 stays for incremental growth, where re-jit
                # amortization dominates.
                cap = _round_up(need, max(_CAP_ALIGN, self.K))
            else:
                cap = _round_up(_pad_pow2(need, lo=self.K), self.K)
            self.state = grow_state(self.state, cap, self.K)

    # --- the public insertion API ---

    def insert_multi(self, reads, already_reversed=False):
        """Insert a batch of reads column-by-column.  ``reads`` are nt6 code
        arrays; unless ``already_reversed``, they are in ORIGINAL orientation
        and reversal (main.c:200-203) happens here.

        The device buffer stores each read 8-aligned with a 0 terminator
        (the ReadStates.pk packing requires aligned starts, and the
        terminator makes the sentinel round implicit)."""
        m = len(reads)
        if m == 0:
            return
        uniform = isinstance(reads, np.ndarray) and reads.ndim == 2
        if uniform:
            lens = np.full(m, reads.shape[1], dtype=np.int32)
        else:
            lens = np.array([len(r) for r in reads], dtype=np.int32)
        total = int(lens.sum()) + m  # symbols + sentinels
        self._plan(total)

        mpad = _pad_pow2(m)
        npad = mpad - m
        if (
            uniform
            and self._pos32_ok(total)
            # pk offsets are int32: the aligned buffer (mpad * stride, which
            # can exceed total symbols by 4-8x for short reads) must fit the
            # same 2^30 bound the ragged path's pkdt guard enforces
            and _pad_pow2(m) * _round_up(reads.shape[1] + 1, 8) <= (1 << 30)
            and os.environ.get("ROPEBWT2_TPU_PACKED", "1") != "0"
            and reads.min() >= 1
            and reads.max() <= 4
        ):
            # ACGT-only uniform matrix: 2-bit packed minimum-transfer path
            self._run_batch_uniform(reads, m, total, already_reversed)
            return
        off = np.zeros(mpad, dtype=np.int64)
        if uniform:  # vectorized fast path for equal-length read matrices
            ln = reads.shape[1]
            stride = _round_up(ln + 1, 8)
            bufcap = _pad_pow2(m * stride, lo=64)
            buf = np.zeros(bufcap, dtype=np.int8)
            mat = reads.astype(np.int8, copy=False)
            if not already_reversed:
                mat = mat[:, ::-1]
            buf.reshape(-1, 8)[: m * stride // 8].reshape(m, stride)[
                :, :ln
            ] = mat
            off[npad:] = np.arange(m, dtype=np.int64) * stride
        else:
            strides = np.asarray(
                [_round_up(len(r) + 1, 8) for r in reads], dtype=np.int64
            )
            starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
            bufcap = _pad_pow2(int(strides.sum()), lo=64)
            buf = np.zeros(bufcap, dtype=np.int8)
            for i, r in enumerate(reads):
                rv = np.asarray(r, dtype=np.int8)
                if not already_reversed:
                    rv = rv[::-1]
                buf[starts[i] : starts[i] + len(rv)] = rv
            off[npad:] = starts
        self._run_batch(buf, off, m, total, int(lens.max()))

    def _run_batch_uniform(self, mat, m, total, already_reversed):
        """2-bit-packed path for uniform ACGT matrices: pack on host, derive
        read state on device, ship ONE array (see bcr_batch_uniform_impl)."""
        L = mat.shape[1]
        stride = _round_up(L + 1, 8)
        mpad = _pad_pow2(m)
        arr = np.zeros((mpad, stride), np.uint8)
        rv = mat.astype(np.uint8, copy=False)
        if not already_reversed:
            rv = rv[:, ::-1]
        arr[:m, :L] = rv - 1  # row j <-> pk offset j*stride (padding rows
        # sit at the FRONT of the state arrays but point at offset -1)
        q = stride // 4  # column-blocked packing (see bcr_batch_uniform_impl)
        packed = (
            (arr[:, :q] << 6)
            | (arr[:, q : 2 * q] << 4)
            | (arr[:, 2 * q : 3 * q] << 2)
            | arr[:, 3 * q :]
        ).reshape(-1)
        scal = np.zeros(4, np.int32)
        scal[0] = m
        scal[1] = self._n_strings
        assert self._n_strings < (1 << 31)
        blob = np.concatenate([packed, scal.view(np.uint8)])
        defer_r, pcap = self._choose_defer(mpad)
        kw = dict(K=self.K, so=self.so, mpad=mpad, L=L, stride=stride,
                  defer_r=defer_r, pcap=pcap)
        self.state, _ = bcr_batch_uniform(self.state, jnp.asarray(blob), **kw)
        self._n += total
        self._n_strings += m
        self._post_batch_runs(total)

    def insert_nul_batch(self, nulbuf: np.ndarray):
        """Insert a batch given as a buffer of NUL-terminated, insertion-
        oriented strings — the exact shape of the reference's -m batch
        buffer (mrope.c:269-277) and of the native reader's output.  The
        strings are re-packed to 8-aligned starts for the pk layout."""
        nulbuf = np.ascontiguousarray(nulbuf).view(np.int8)
        ends = np.flatnonzero(nulbuf == 0)
        m = len(ends)
        if m == 0:
            return
        total = int(nulbuf.shape[0])  # symbols + sentinels
        assert ends[-1] == total - 1, "batch must end with a terminator"
        self._plan(total)
        starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int64)
        lens = (ends - starts).astype(np.int64)

        mpad = _pad_pow2(m)
        npad = mpad - m
        strides = (lens + 8) & ~np.int64(7)  # round_up(len+1, 8)
        astarts = np.concatenate([[0], np.cumsum(strides)[:-1]])
        bufcap = _pad_pow2(int(strides.sum()), lo=64)
        buf = np.zeros(bufcap, dtype=np.int8)
        # scatter the whole NUL-delimited batch into the aligned layout in
        # one vectorized move (terminators included)
        dst = (astarts - starts).repeat(lens + 1) + np.arange(
            total, dtype=np.int64
        )
        buf[dst] = nulbuf
        off = np.zeros(mpad, dtype=np.int64)
        off[npad:] = astarts
        self._run_batch(buf, off, m, total, int(lens.max()))

    def _pos32_ok(self, extra):
        """True when partition-LOCAL interval values stay < 2^31 through
        this batch (max current partition size + all new symbols): the
        stored l/u are partition-relative, so they remain int32 far past
        2^31 total symbols — only the global rank/merge touchpoints run
        int64 (plan_round's gdt).  Costs one 48-byte psize pull per batch
        above the int32 capacity bound."""
        if self.state.cap < (1 << 31) - 1:
            return True
        psz = int(np.asarray(self.state.psize).max())
        return psz + extra + (1 << 20) < (1 << 31)

    def _run_batch(self, buf, off, m, total, max_len):
        mpad = off.shape[0]
        npad = mpad - m
        n_sent = self._n_strings
        # int32 halves the bytes of every M-wide pass: intervals are
        # partition-local, so int32 applies while every PARTITION fits
        pdt = np.int32 if self._pos32_ok(total) else np.int64
        pkdt = np.int32 if buf.shape[0] <= (1 << 30) else np.int64
        # pk = (off // 8) << 3 | c, with c = 0 initially; pk < 0 marks the
        # padding rows (they point nowhere and never activate)
        pk = np.full(mpad, -1, dtype=pkdt)
        pk[npad:] = off[npad:]  # off is 8-aligned: off == (off//8)<<3
        l = np.zeros(mpad, dtype=pdt)
        u = np.zeros(mpad, dtype=pdt)
        if self.so == SO_IO:
            l[npad:] = n_sent + np.arange(m)
            u[npad:] = l[npad:]
        else:
            u[npad:] = n_sent
        # round-range chunking for kilobase+ reads: a single fori dispatch
        # over tens of thousands of rounds would run for minutes; split
        # into ~CHUNK-round dispatches (state + read state stay resident
        # between them)
        rounds = max_len + 1
        chunk = int(os.environ.get("ROPEBWT2_TPU_ROUND_CHUNK", "2048"))
        defer_r, pcap = self._choose_defer(mpad)
        if defer_r > 0 and chunk > 0:
            chunk = max(chunk // defer_r, 1) * defer_r
        use_chunked = chunk > 0 and rounds > 2 * chunk
        if use_chunked:
            rs = ReadStates(
                l=jnp.asarray(l), u=jnp.asarray(u), pk=jnp.asarray(pk)
            )
            jbuf = jnp.asarray(buf)
            st = self.state
            d = 0
            while d < rounds:
                hi = min(d + chunk, rounds)
                st, rs = bcr_batch_range(
                    st, rs, jbuf, jnp.asarray(d, I64), jnp.asarray(hi, I64),
                    K=self.K, so=self.so, defer_r=defer_r, pcap=pcap,
                )
                d = hi
            state = st
        elif (
            pdt == np.int32
            and pkdt == np.int32
            and os.environ.get("ROPEBWT2_TPU_PACKED", "1") != "0"
        ):
            # halve the host->device buffer (nibble pack) and ride state +
            # round count on ONE array
            meta = np.empty(1 + 3 * mpad, np.int32)
            meta[0] = max_len + 1
            meta[1 : 1 + mpad] = l
            meta[1 + mpad : 1 + 2 * mpad] = u
            meta[1 + 2 * mpad : 1 + 3 * mpad] = pk
            # plane-wise nibble pack (values <= 6: stays exact); bufcap is a
            # power of two so the halves are exact
            half = buf.shape[0] // 2
            pbuf = (buf[:half] << 4) | buf[half:]
            defer_r, pcap = self._choose_defer(mpad)
            kw = dict(K=self.K, so=self.so, mpad=mpad, defer_r=defer_r,
                      pcap=pcap)
            state, _ = bcr_batch_packed(
                self.state, jnp.asarray(meta), jnp.asarray(pbuf), **kw
            )
        else:
            rs = ReadStates(
                l=jnp.asarray(l),
                u=jnp.asarray(u),
                pk=jnp.asarray(pk),
            )
            defer_r, pcap = self._choose_defer(mpad)
            state, _ = bcr_batch(
                self.state,
                rs,
                jnp.asarray(buf),
                jnp.asarray(max_len + 1, dtype=I64),
                K=self.K,
                so=self.so,
                defer_r=defer_r,
                pcap=pcap,
            )
        self.state = state
        self._n += total
        self._n_strings += m
        self._post_batch_runs(total)

    def insert1(self, read):
        """Single-string insertion (mr_insert1 semantics).  Identical output
        to a one-read batch — the reference's Algorithm 2 degenerates to
        Algorithm 1 when l == u (tex/ropebwt2.tex:108-110)."""
        self.insert_multi([read])

    # --- export ---

    @property
    def n(self) -> int:
        return self._n

    def counts(self):
        """Global per-symbol counts ($,A,C,G,T,N), like mr_get_c.  One
        device->host pull; the 36-entry reduction runs on the host."""
        return np.asarray(self.state.pcounts).sum(axis=0)

    def bwt_array(self) -> np.ndarray:
        """The full BWT as an int8 numpy array (host transfer)."""
        from ..index.packed import PackedFlatBwt, unpack_bwt_np
        from ..index.runs import RunBwt, runs_to_host

        n = self.n
        if isinstance(self.state, RunBwt):
            assert int(self.state.overflow) == 0, "run-tier envelope breach"
            syms, lens = runs_to_host(self.state)
            out = np.repeat(syms, lens)
            assert out.shape[0] == n, (out.shape[0], n)
            return out
        if isinstance(self.state, PackedFlatBwt):
            nb = -(-n // 256) * 128  # packed bytes covering the prefix
            return unpack_bwt_np(np.asarray(self.state.pbwt[:nb]))[:n]
        return np.asarray(self.state.bwt[:n])

    def runs(self):
        """Run-length view [(sym, len), ...] of the BWT."""
        b = self.bwt_array()
        if b.size == 0:
            return []
        change = np.flatnonzero(np.diff(b)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [b.size]])
        return [
            (int(b[s]), int(e - s)) for s, e in zip(starts, ends)
        ]
