"""Run-length compressed BWT state — the O(runs) device tier.

The reference's defining capability is memory: its index IS run-length
encoded (rle.h:39-75 1/2/4/8-byte runs inside 512-byte B+-tree leaves;
rld0.h:11-13 superblock frames), which is how 122 Gbp fits in 34 GB
(README.md:36-39).  The flat tiers here (index/flat.py int8, index/
packed.py 4-bit) store O(n) and also PAY O(n) per merge flush.  This tier
stores and rewrites O(runs): on coverage-shaped read sets (the
reference's benchmark datasets are 39-47x resequencing runs) that is an
order of magnitude less device memory for storage, rank gathers AND the
flush.

Representation (structure-of-arrays, fixed 128-run blocks — the array
analogue of the reference's fixed-size rle leaves):

* ``rsym``  int8[rcap]   run symbols; PAD beyond the live slot prefix.
* ``rend``  int32[rcap]  BLOCK-RELATIVE inclusive cumulative run ends:
            rend[i] = total symbols of runs (b*128..i] within i's block b.
            Tail slots repeat the block's last live value (length 0).
            Block symbol totals must stay < 2^31 (per-run lengths are
            bounded by RUN_LEN_MAX and checked at flush time).
* ``bstart`` gdt[nbl]    global symbol position of each block's first run;
            +INF for fully-dead blocks (descent sentinel).  int32 while
            total symbols < 2^31, int64 beyond (the gdt rule of
            engine/bcr.py).
* ``bocc``  gdt[nbl, 6]  per-symbol counts before each block.
* ``nslot`` int64        live slot count (slots [0, nslot) are real runs;
            the flush emits NO zero-length runs — see below).
* ``n/psize/pcounts``    as in flat.FlatBwt.

Rank (rank_global_runs): blocked descent over ``bstart`` (the same
structure as pending.searchsorted_blocked) -> block jb + its start value
(recovered from the final descent row — no extra gather), then one
(Q,128) int32 ``rend`` row + one (Q,128) int8 ``rsym`` row + the (Q,6)
``bocc`` row:  occ[s] = bocc[jb,s] + sum_i clamp(rem - start_i, 0, len_i)
over the block's runs with symbol s.  Run boundaries never need to be
located exactly — the clamp form counts partial overlap directly.

Batched insertion (apply_insertions_runs) re-expresses rle_insert's
split/extend/merge cases (rle.c:10-97) as one vectorized pass over
insertion ITEMS with three slot-economy rules that keep the output free
of zero-length runs (so the log-shift insertion expand of
index/pending.py stays valid — it cannot express drops):

1. an insertion whose symbol equals its host run's symbol is an EXTEND:
   it emits no item; its +1 is folded into the piece to its left;
2. a split's right piece (the host tail) is emitted only when its length
   (gap to the next split + extends inside the gap) is > 0;
3. consecutive equal-(position, symbol) splits merge into ONE item of
   their count, and the FIRST split at offset 0 of a run REPLACES the
   host slot in place (the host's left piece would be empty).

End-of-sequence insertions need no special casing: they resolve to the
phantom host slot at index nslot (PAD, length 0), which rule 3 replaces.

No structural counterpart exists in the reference beyond the shared math
of run splitting; this is the device re-expression of rle.c's economics.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import NSYM
from .flat import PAD
from .scan import cumsum_blocked, cummax_blocked, cummin_blocked, cumsum_small

I32 = jnp.int32
I64 = jnp.int64
KR = 128  # runs per block
RUN_LEN_MAX = 1 << 24  # per-run length envelope (keeps block totals < 2^31)
_F = 128  # descent fanout
RCAP_ALIGN = KR * _F  # rcap granularity: level-0 descent arrays (bstart of
#                       nbl = rcap/KR entries, E of rcap entries) must be
#                       multiples of the fanout


def _inf(dt):
    return jnp.iinfo(dt).max - (1 << 28)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RunBwt:
    rsym: jax.Array  # int8[rcap]
    rend: jax.Array  # int32[rcap] block-relative inclusive ends
    bstart: jax.Array  # gdt[rcap//KR] block global starts (+INF dead)
    bocc: jax.Array  # gdt[rcap//KR, 6] per-symbol counts before block
    nslot: jax.Array  # int64 scalar live slots
    n: jax.Array  # int64 scalar total symbols
    psize: jax.Array  # int64[6]
    pcounts: jax.Array  # int64[6,6]
    overflow: jax.Array  # int32 scalar: sticky flag (slot overflow /
    #                      run-length envelope breach) — driver asserts 0

    @property
    def rcap(self) -> int:
        return self.rsym.shape[0]

    @property
    def cap(self) -> int:
        """Symbol capacity bound used by the engine's dtype rules: the
        run tier has no fixed symbol capacity; report a value consistent
        with the gdt of its tables."""
        return (1 << 30) if self.bstart.dtype == I32 else (1 << 40)


def gdt_for_symbols(total: int):
    return I32 if total < (1 << 31) - (1 << 29) else I64


def empty_runs_state(rcap: int, total_symbol_bound: int) -> RunBwt:
    assert rcap % RCAP_ALIGN == 0
    gdt = gdt_for_symbols(total_symbol_bound)
    nbl = rcap // KR
    return RunBwt(
        rsym=jnp.full((rcap,), PAD, jnp.int8),
        rend=jnp.zeros((rcap,), I32),
        bstart=jnp.full((nbl,), _inf(gdt), gdt),
        bocc=jnp.zeros((nbl, NSYM), gdt),
        nslot=jnp.zeros((), I64),
        n=jnp.zeros((), I64),
        psize=jnp.zeros((NSYM,), I64),
        pcounts=jnp.zeros((NSYM, NSYM), I64),
        overflow=jnp.zeros((), I32),
    )


def grow_runs_state(state: RunBwt, new_rcap: int) -> RunBwt:
    assert new_rcap % RCAP_ALIGN == 0 and new_rcap >= state.rcap
    if new_rcap == state.rcap:
        return state
    nbl = new_rcap // KR
    gdt = state.bstart.dtype
    return dataclasses.replace(
        state,
        rsym=jnp.concatenate(
            [state.rsym,
             jnp.full((new_rcap - state.rcap,), PAD, jnp.int8)]
        ),
        rend=jnp.concatenate(
            [state.rend, jnp.zeros((new_rcap - state.rcap,), I32)]
        ),
        bstart=jnp.concatenate(
            [state.bstart,
             jnp.full((nbl - state.bstart.shape[0],), _inf(gdt), gdt)]
        ),
        bocc=jnp.concatenate(
            [state.bocc,
             jnp.zeros((nbl - state.bocc.shape[0], NSYM), gdt)]
        ),
    )


def _levels(arr):
    """Descent level pyramid for a sorted array (INF-tailed)."""
    levels = [arr]
    while levels[-1].shape[0] > _F:
        nxt = levels[-1][::_F]
        if nxt.shape[0] % _F and nxt.shape[0] > _F:
            pad = _F - nxt.shape[0] % _F
            nxt = jnp.concatenate(
                [nxt, jnp.full((pad,), jnp.iinfo(arr.dtype).max, arr.dtype)]
            )
        levels.append(nxt)
    return levels


def searchsorted_le_value(arr, g):
    """(cnt, val): cnt[q] = |{ i : arr[i] <= g[q] }| for sorted ``arr``
    and val[q] = arr[cnt-1] (the last element <= g; arr.min-like garbage
    when cnt == 0).  The boundary value is recovered from the final
    descent row — no extra gather."""
    assert arr.shape[0] <= _F or arr.shape[0] % _F == 0, arr.shape
    gq = g[:, None].astype(arr.dtype)
    levels = _levels(arr)
    top = levels[-1]
    cnt = jnp.sum(top[None, :] <= gq, axis=1, dtype=I32)
    j = jnp.maximum(cnt - 1, 0)
    for lvl in levels[-2:0:-1]:
        rows = lvl.reshape(-1, _F)[j]
        c = jnp.sum(rows <= gq, axis=1, dtype=I32)
        j = jnp.maximum(j * _F + c - 1, 0)
    rows = levels[0].reshape(-1, _F)[j] if len(levels) > 1 else (
        jnp.broadcast_to(arr[None, :], (g.shape[0], arr.shape[0]))
    )
    inb = rows <= gq
    c = jnp.sum(inb, axis=1, dtype=I32)
    minv = jnp.iinfo(arr.dtype).min
    val = jnp.max(jnp.where(inb, rows, minv), axis=1)
    zero = arr[0] > gq[:, 0]
    cnt_full = jnp.where(zero, 0, j * _F + c) if len(levels) > 1 else (
        jnp.where(zero, 0, c)
    )
    return cnt_full.astype(I32), val


def rank_global_runs(rend, rsym, bstart, bocc, g):
    """Batched 6-symbol rank at global positions g (0 <= g <= n).
    Returns (Q, 6) in bocc's dtype."""
    cnt, bs = searchsorted_le_value(bstart, g)
    jb = jnp.maximum(cnt - 1, 0)
    rem = (g.astype(bstart.dtype) - bs).astype(I32)
    erow = rend.reshape(-1, KR)[jb]  # (Q,128) i32
    srow = rsym.reshape(-1, KR)[jb]  # (Q,128) i8
    start = jnp.concatenate(
        [jnp.zeros((erow.shape[0], 1), I32), erow[:, :-1]], axis=1
    )
    ln = erow - start
    taken = jnp.clip(rem[:, None] - start, 0, ln)  # (Q,128)
    occ = bocc[jb]
    s32 = srow.astype(I32)
    cols = []
    for s in range(NSYM):
        cols.append(
            jnp.sum(jnp.where(s32 == s, taken, 0), axis=1, dtype=I32)
        )
    inc = jnp.stack(cols, axis=1)
    return occ + inc.astype(bocc.dtype)


def _roll1(x, fill):
    return jnp.concatenate(
        [jnp.full((1,), fill, x.dtype), x[:-1]]
    )


def _shift_up1(x, fill):
    return jnp.concatenate(
        [x[1:], jnp.full((1,), fill, x.dtype)]
    )


def _rebuild_tables(lens, syms, nslot, gdt):
    """(rend, bstart, bocc) from per-slot lengths/symbols (dead slots must
    already be (0, PAD))."""
    rcap = lens.shape[0]
    nbl = rcap // KR
    lb = lens.reshape(nbl, KR)
    # in-block inclusive prefix via shift-adds (see index/scan.py)
    rend = cumsum_small(lb, axis=1).reshape(rcap)
    btot = rend.reshape(nbl, KR)[:, KR - 1].astype(gdt)  # block totals
    bstart = jnp.concatenate(
        [jnp.zeros((1,), gdt), cumsum_small(btot)[:-1]]
    )
    blk_dead = (
        jnp.arange(nbl, dtype=I64) * KR >= nslot.astype(I64)
    )
    bstart = jnp.where(blk_dead, _inf(gdt), bstart)
    sb = syms.reshape(nbl, KR).astype(I32)
    occ_cols = []
    for s in range(NSYM):
        occ_cols.append(
            jnp.sum(jnp.where(sb == s, lb, 0), axis=1, dtype=I32)
        )
    bcnt = jnp.stack(occ_cols, axis=1).astype(gdt)  # (nbl, 6)
    bocc = jnp.concatenate(
        [jnp.zeros((1, NSYM), gdt), cumsum_small(bcnt, axis=0)[:-1]]
    )
    return rend, bstart, bocc


def _plan_items(state: RunBwt, pos, sym, stream, valid):
    """Shared planning stage of the batched run insertion: classify cuts
    (split/extend), compute items with the slot-economy rules, scatter
    them to merged slots, and apply host trims/replacements to the OLD
    per-slot arrays.  Returns (old_len, old_sym, ns_arr, nl_arr,
    n_items, used_phantom) — see apply_insertions_runs."""
    rcap = state.rcap
    gdt = state.bstart.dtype
    M = pos.shape[0]
    nslot32 = state.nslot.astype(I32)

    # ---- compact insertions to dense rows 0..A-1 (stream is the dense
    # rank over valid rows): two narrow M-scatters ----
    tgt = jnp.where(valid, stream.astype(I32), M)
    cpos = jnp.zeros((M,), gdt).at[tgt].set(
        pos.astype(gdt), mode="drop", unique_indices=True)
    csym = jnp.full((M,), PAD, jnp.int8).at[tgt].set(
        sym.astype(jnp.int8), mode="drop", unique_indices=True)
    A = jnp.sum(valid, dtype=I32)
    row = jnp.arange(M, dtype=I32)
    live = row < A
    INFg = _inf(gdt)
    cpos = jnp.where(live, cpos, INFg)

    # ---- host run of each insertion ----
    # per-slot lengths: rend - previous rend, reset at block boundaries
    idxr = jnp.arange(rcap, dtype=I32)
    lens0 = state.rend - jnp.where(idxr % KR == 0, 0, _roll1(state.rend, 0))
    E = state.bstart[
        (jnp.arange(rcap, dtype=I32) // KR)
    ] + state.rend.astype(gdt)  # global run ends; INF-ish in dead blocks
    E = jnp.minimum(E, INFg)
    # rix = #(E <= pos): the run containing pos, or nslot for end-inserts
    rix, _ = searchsorted_le_value(E, cpos)
    rix = jnp.minimum(rix, nslot32)
    rixc = jnp.minimum(rix, rcap - 1)
    lenr = jnp.where(live, lens0[rixc], 0)
    hostsym = jnp.where(live, state.rsym[rixc], PAD).astype(jnp.int8)
    estart = E[rixc] - lenr.astype(gdt)
    off = jnp.clip(cpos - estart, 0, lenr.astype(gdt)).astype(I32)
    off = jnp.where(live, off, 0)

    # ---- group/segment structure over dense rows ----
    ghead = (row == 0) | (rix != _roll1(rix, -1))  # per-host-run groups
    ext = live & (csym == hostsym)  # extends: no item
    sp = live & jnp.logical_not(ext)  # splits

    cex = cumsum_blocked(ext.astype(I32))  # inclusive extend count
    base = cummax_blocked(jnp.where(ghead, cex - ext.astype(I32), 0))
    ce = cex - base  # extends before+incl me within my group (incl own)

    BIG = jnp.asarray((1 << 30), I32)
    # group last row: next head - 1
    nh = cummin_blocked(jnp.where(ghead, row, BIG), reverse=True)
    nh = _shift_up1(nh, BIG)  # next head strictly after me
    gl = jnp.minimum(nh - 1, M - 1)
    # next split at-or-after / strictly-after me
    ts = jnp.where(sp, row, BIG)
    ns_incl = cummin_blocked(ts, reverse=True)
    ns = _shift_up1(ns_incl, BIG)  # next split strictly after me
    # first split of my group (propagate head's ns_incl forward)
    fs = cummax_blocked(jnp.where(ghead, ns_incl, 0))

    nsc = jnp.minimum(ns, M - 1)
    in_group_ns = ns <= gl
    off_ns = jnp.where(in_group_ns, off[nsc], lenr)
    ce_ns = jnp.where(in_group_ns, ce[nsc] - ext[nsc].astype(I32),
                      ce[jnp.minimum(gl, M - 1)])
    # extends strictly between me and the group end/next split
    blen = (off_ns - off) + (ce_ns - ce)

    # A-dup merge: consecutive splits with equal (rix, off, sym)
    prev_is_dup = (
        sp & _roll1(sp, False)
        & (rix == _roll1(rix, -1))
        & (off == _roll1(off, -1))
        & (csym == _roll1(csym, PAD))
    )
    ahead = sp & jnp.logical_not(prev_is_dup)
    # dup-group length: next non-dup row - my row
    nd = cummin_blocked(
        jnp.where(jnp.logical_not(prev_is_dup), row, BIG), reverse=True
    )
    nd = _shift_up1(nd, BIG)
    alen = jnp.where(ahead, jnp.minimum(nd, M) - row, 0)

    # host trim / replace (computed at group heads)
    fsc = jnp.minimum(fs, M - 1)
    has_split = fs <= gl
    trim = jnp.where(
        has_split, off[fsc] + (ce[fsc] - ext[fsc].astype(I32)),
        lenr + ce[jnp.minimum(gl, M - 1)],
    )
    replace = has_split & (trim == 0)  # first split's A-group takes host
    host_len = jnp.where(replace, alen[fsc], trim)
    host_sym = jnp.where(replace, csym[fsc], hostsym)

    # item emission.  ``replace`` is group-constant (all its inputs are
    # group-propagated), so the first split's A-group is suppressed
    # row-locally.
    emitA = ahead & jnp.logical_not(replace & (row == fs))
    emitB = sp & (blen > 0)
    ic = emitA.astype(I32) + emitB.astype(I32)
    icum = cumsum_blocked(ic) - ic  # exclusive item count before me

    # ---- scatters: items into the merged slot arrays, host overrides
    # into the OLD arrays (pre-expand) ----
    slotA = jnp.where(emitA, rix + 1 + icum, rcap)
    slotB = jnp.where(emitB, rix + 1 + icum + emitA.astype(I32), rcap)
    ns_arr = jnp.zeros((rcap,), jnp.int8)
    nl_arr = jnp.zeros((rcap,), I32)
    ns_arr = ns_arr.at[slotA].set((csym + 1).astype(jnp.int8), mode="drop",
                                  unique_indices=True)
    nl_arr = nl_arr.at[slotA].set(alen, mode="drop", unique_indices=True)
    ns_arr = ns_arr.at[slotB].set((hostsym + 1).astype(jnp.int8),
                                  mode="drop", unique_indices=True)
    nl_arr = nl_arr.at[slotB].set(blen, mode="drop", unique_indices=True)
    is_new = ns_arr != 0

    htgt = jnp.where(ghead & live, rix, rcap)
    old_len = lens0.at[htgt].set(host_len, mode="drop",
                                 unique_indices=True)
    old_sym = state.rsym.at[htgt].set(host_sym, mode="drop",
                                      unique_indices=True)
    n_items = jnp.sum(ic, dtype=I64)
    # end-inserts may REPLACE the phantom host slot at nslot: it becomes
    # live when any group targeted rix == nslot
    used_phantom = jnp.any(ghead & live & (rix == nslot32))
    return old_len, old_sym, ns_arr, nl_arr, n_items, used_phantom


def apply_insertions_runs(state: RunBwt, pos, sym, stream, valid):
    """Apply one coalesced batch of insertions to the run array.

    pos: int[M] old-coordinate global insertion points (non-decreasing
    over valid rows); sym: int32[M]; stream: int[M] dense tie ranks over
    valid rows consistent with pos order; valid: bool[M].

    Returns the updated (rsym, rend, bstart, bocc, nslot, overflow)
    fields as a dict for dataclasses.replace.

    Two expand formulations: the monolithic log-shift ladder (full-width
    temporaries ~19 B/slot — fine to a few hundred Msym of runs), and a
    CHUNKED backward in-place ladder for large rcap (temporaries bounded
    by the chunk; see _expand_chunked) selected when rcap >= RUNS_BIG."""
    rcap = state.rcap
    gdt = state.bstart.dtype
    M = pos.shape[0]
    old_len, old_sym, ns_arr, nl_arr, n_items, used_phantom = _plan_items(
        state, pos, sym, stream, valid
    )
    if (rcap >= RUNS_BIG and 2 * M <= RUNS_CHUNK
            and rcap % RUNS_CHUNK == 0):
        new_len, new_sym = _expand_chunked(
            old_len, old_sym, ns_arr, nl_arr, M,
            live_slots=state.nslot + 2 * jnp.asarray(M, I64),
        )
    else:
        new_len, new_sym = _expand_monolithic(
            old_len, old_sym, ns_arr, nl_arr, M
        )
    new_nslot = state.nslot + n_items + used_phantom.astype(I64)

    # repair tails (old garbage shifted up) and guard the envelopes
    slot = jnp.arange(rcap, dtype=I64)
    dead = slot >= new_nslot
    new_len = jnp.where(dead, 0, new_len)
    new_sym = jnp.where(dead, PAD, new_sym)
    overflow = state.overflow \
        + (new_nslot > rcap - KR).astype(I32) \
        + jnp.any(new_len >= RUN_LEN_MAX).astype(I32)

    rend, bstart, bocc = _rebuild_tables(new_len, new_sym, new_nslot, gdt)
    return dict(rsym=new_sym, rend=rend, bstart=bstart, bocc=bocc,
                nslot=new_nslot, overflow=overflow)


def _expand_monolithic(old_len, old_sym, ns_arr, nl_arr, M):
    rcap = old_len.shape[0]
    is_new = ns_arr != 0
    # ---- expand old slots by the is_new prefix (log-shift ladder) ----
    c = cumsum_blocked(is_new.astype(I32))
    vo, so_ = old_len, old_sym
    nbits = max(int(M).bit_length() + 1, 1)
    for kk in range(nbits - 1, -1, -1):
        step = 1 << kk
        if step >= rcap:
            continue
        take = ((c >> kk) & 1) == 1
        vo = jnp.where(
            take,
            jnp.concatenate([jnp.zeros((step,), I32), vo[:-step]]), vo,
        )
        so_ = jnp.where(
            take,
            jnp.concatenate(
                [jnp.full((step,), PAD, jnp.int8), so_[:-step]]
            ),
            so_,
        )
    new_len = jnp.where(is_new, nl_arr, vo)
    new_sym = jnp.where(is_new, ns_arr - 1, so_)
    return new_len, new_sym


import os as _os

RUNS_BIG = int(_os.environ.get("ROPEBWT2_TPU_RUNS_BIG", 1 << 26))
# ^ slots above which the chunked expand applies (env override for tests)
RUNS_CHUNK = 1 << 24  # chunk size (slots) of the chunked expand


def _expand_chunked(old_len, old_sym, ns_arr, nl_arr, M, live_slots=None):
    """Backward in-place chunked insertion expand: out[p] = old[p - c(p)]
    for non-item slots, processed one RUNS_CHUNK at a time from the TOP
    chunk down.  The expand only moves content to HIGHER slots, so
    writing chunk k can never clobber anything a later (lower) chunk
    reads, and the loop carries the arrays in place — temporaries are
    chunk-sized instead of ~19 B/slot full-width.

    Per-chunk: the old source window is [kCH - S[k+1], (k+1)CH) (S =
    exclusive per-chunk item-count prefix; window size CH + icmax, with
    the precondition 2M <= CH so the window start stays >= 0 for k >= 1);
    the variable gather runs as the mirrored log-shift ladder with the
    NON-INCREASING forward shift d(p) = S[k+1] - c(p) (slope >= -1, so
    source indices are monotone and bit-by-bit shifting is exact, the
    mirror of index/pending.py's log-shift expand).  Chunk 0 uses
    the plain backward-shift ladder on a [0, CH) window."""
    rcap = old_len.shape[0]
    CH = RUNS_CHUNK
    assert rcap % CH == 0 and 2 * M <= CH
    nch = rcap // CH
    ibits = max(int(2 * M - 1).bit_length(), 1)
    P = 1 << ibits  # window slack = pow2 bound on total items
    W = CH + P
    is_new_full = ns_arr != 0
    chunk_items = jnp.sum(
        is_new_full.reshape(nch, CH), axis=1, dtype=I32
    )
    S = jnp.concatenate(
        [jnp.zeros(1, I32), cumsum_small(chunk_items)]
    )
    # tail-pad the carried arrays so the top chunk's window never makes
    # dynamic_slice clamp (which would silently shift the window)
    ln0 = jnp.concatenate([old_len, jnp.zeros((P,), I32)])
    sy0 = jnp.concatenate([old_sym, jnp.full((P,), PAD, jnp.int8)])

    def chunk_io(arrs, kCH):
        nsl = jax.lax.dynamic_slice(ns_arr, (kCH,), (CH,))
        nll = jax.lax.dynamic_slice(nl_arr, (kCH,), (CH,))
        isn = nsl != 0
        lp = cumsum_blocked(isn.astype(I32))  # inclusive local prefix
        return nsl, nll, isn, lp

    def body(i, carry):
        # chunks nch-1 .. 1 backward; out[p] = old[p - c(p)] with
        # c(p) = S[k] + lp(po); window [kCH - S[k+1], ...):
        # source_local = po + (icr - lp(po)) — a non-increasing forward
        # shift, slope >= -1, so sources are monotone and the bit ladder
        # is exact (mirror of the merge expand argument)
        k = nch - 1 - i
        ln, sy = carry
        kCH = k * CH
        icr = S[k + 1] - S[k]
        ws = kCH - S[k + 1]  # >= CH - 2M >= 0 for k >= 1
        winl = jax.lax.dynamic_slice(ln, (ws,), (W,))
        wins = jax.lax.dynamic_slice(sy, (ws,), (W,))
        nsl, nll, isn, lp = chunk_io((ln, sy), kCH)
        d = icr - lp  # in [0, icr]
        dpad = jnp.concatenate([d, jnp.zeros((W - CH,), I32)])
        vl, vs = winl, wins
        for kk in range(ibits - 1, -1, -1):
            step = 1 << kk
            take = ((dpad >> kk) & 1) == 1
            vl = jnp.where(
                take,
                jnp.concatenate([vl[step:], jnp.zeros((step,), I32)]),
                vl,
            )
            vs = jnp.where(
                take,
                jnp.concatenate(
                    [vs[step:], jnp.full((step,), PAD, jnp.int8)]
                ),
                vs,
            )
        out_l = jnp.where(isn, nll, vl[:CH])
        out_s = jnp.where(isn, nsl - 1, vs[:CH])
        ln = jax.lax.dynamic_update_slice(ln, out_l, (kCH,))
        sy = jax.lax.dynamic_update_slice(sy, out_s, (kCH,))
        return ln, sy

    # only chunks holding live content need processing (rcap carries
    # allocation slack; slots past nslot + items are INF/PAD either way
    # and the caller's tail repair renormalizes them)
    if live_slots is None:
        nch_live = nch
    else:
        nch_live = jnp.clip(
            (live_slots.astype(I64) + CH - 1) // CH, 1, nch
        ).astype(I32)
    ln, sy = jax.lax.fori_loop(
        0, jnp.maximum(nch_live - 1, 0),
        lambda i, c: body(i + (nch - nch_live), c), (ln0, sy0),
    )

    # chunk 0: plain backward-shift expand on the [0, CH) window
    # (out[po] = win[po - lp(po)])
    nsl, nll, isn, lp = chunk_io((ln, sy), 0)
    vl = ln[:CH]
    vs = sy[:CH]
    for kk in range(ibits - 1, -1, -1):
        step = 1 << kk
        take = ((lp >> kk) & 1) == 1
        vl = jnp.where(
            take,
            jnp.concatenate([jnp.zeros((step,), I32), vl[:-step]]),
            vl,
        )
        vs = jnp.where(
            take,
            jnp.concatenate(
                [jnp.full((step,), PAD, jnp.int8), vs[:-step]]
            ),
            vs,
        )
    out_l = jnp.where(isn, nll, vl)
    out_s = jnp.where(isn, nsl - 1, vs)
    ln = jax.lax.dynamic_update_slice(ln, out_l, (0,))
    sy = jax.lax.dynamic_update_slice(sy, out_s, (0,))
    return ln[:rcap], sy[:rcap]


def runs_from_arrays(syms_np, lens_np, rcap, total_symbol_bound,
                     n, psize, pcounts):
    """Build a RunBwt from host-side run arrays (conversion path)."""
    nr = syms_np.shape[0]
    assert rcap % RCAP_ALIGN == 0 and rcap >= nr + KR
    assert (lens_np > 0).all() and (lens_np < RUN_LEN_MAX).all()
    gdt = gdt_for_symbols(total_symbol_bound)
    syms = np.full(rcap, PAD, np.int8)
    syms[:nr] = syms_np
    lens = np.zeros(rcap, np.int32)
    lens[:nr] = lens_np
    lens_j = jnp.asarray(lens)
    syms_j = jnp.asarray(syms)
    nslot = jnp.asarray(nr, I64)
    rend, bstart, bocc = _rebuild_tables(lens_j, syms_j, nslot, gdt)
    return RunBwt(
        rsym=syms_j, rend=rend, bstart=bstart, bocc=bocc,
        nslot=nslot,
        n=jnp.asarray(n, I64),
        psize=jnp.asarray(psize, I64),
        pcounts=jnp.asarray(pcounts, I64),
        overflow=jnp.zeros((), I32),
    )


def runs_to_host(state: RunBwt):
    """(syms, lens) live run arrays on host (zero-length slots dropped —
    the flush emits none, but be tolerant)."""
    ns = int(state.nslot)
    syms = np.asarray(state.rsym[: max(ns, 1)])[:ns]
    rend = np.asarray(state.rend[: max(ns, 1)])[:ns]
    idx = np.arange(ns)
    prev = np.where(idx % KR == 0, 0, np.concatenate([[0], rend[:-1]]))
    lens = rend - prev
    keep = lens > 0
    return syms[keep], lens[keep]
