"""Batched FM-index query API — the library surface downstream tools use
(mr_rank2a, mrope.c:70-105; rld_rank1a/2a + rld_extend, rld0.c:357-489).

All functions are jit-compiled and operate on batches of queries: positions
(Q,), intervals (Q, 2), or bi-intervals (Q, 3) in rld's convention
x = (backward start, forward start, size) (rld0.h:43-46).
"""

import functools

import jax
import jax.numpy as jnp

from ..alphabet import NSYM
from ..index.rank import rank_global
from ..index.scan import cumsum_small

I64 = jnp.int64


def _state_K(state, K):
    """Block size is derivable from the state's shapes; an explicit K only
    needs to be passed to override (and must then match the engine's)."""
    from ..index.packed import PackedFlatBwt
    from ..index.runs import RunBwt

    if isinstance(state, (PackedFlatBwt, RunBwt)):
        return 128  # packed tables per symbol-row; run tier K-free
    if K is not None:
        return K
    return state.bwt.shape[0] // (state.blk_prefix.shape[0] - 1)


def _pos_dtype(state):
    from ..index.packed import PackedFlatBwt
    from ..index.runs import RunBwt

    if isinstance(state, RunBwt):
        return state.bstart.dtype
    if isinstance(state, PackedFlatBwt):
        return I64 if state.cap >= (1 << 31) else jnp.int32
    return state.blk_prefix.dtype


def _base_rank(state, pos, K):
    from ..index.packed import PackedFlatBwt, rank_global_packed
    from ..index.rank import rank_global as _rg
    from ..index.runs import RunBwt, rank_global_runs

    if isinstance(state, RunBwt):
        return rank_global_runs(
            state.rend, state.rsym, state.bstart, state.bocc, pos
        ).astype(_pos_dtype(state))
    if isinstance(state, PackedFlatBwt):
        return rank_global_packed(
            state.pbwt, state.blkA, state.blkB, pos
        ).astype(_pos_dtype(state))
    return _rg(state.bwt, state.blk_prefix, pos, K)


def _C(state):
    """Accumulative counts C(a) = # symbols < a (rld's e->cnt after finish).
    shape (7,): C[6] = total.  Returned in the index's position dtype
    (int32 while the capacity fits)."""
    tot = state.pcounts.sum(axis=0)
    C = jnp.concatenate([jnp.zeros(1, I64), cumsum_small(tot)])
    return C.astype(_pos_dtype(state))


@functools.partial(jax.jit, static_argnames=("K",))
def rank1a(state, pos, *, K=None):
    """occ[q, s] = # of symbol s in BWT[0:pos[q]] (rld_rank1a / mr_rank2a
    single-point)."""
    return _base_rank(
        state, pos.astype(_pos_dtype(state)), _state_K(state, K)
    )


@functools.partial(jax.jit, static_argnames=("K",))
def rank2a(state, x, y, *, K=None):
    """Two-point rank: returns (occ_x, occ_y), each (Q, 6)."""
    K = _state_K(state, K)
    pdt = _pos_dtype(state)
    ox = _base_rank(state, x.astype(pdt), K)
    oy = _base_rank(state, y.astype(pdt), K)
    return ox, oy


@functools.partial(jax.jit, static_argnames=("K",))
def rank11(state, pos, c, *, K=None):
    """Single-symbol rank (rld_rank11): # of symbol c[q] in BWT[0:pos[q]]."""
    occ = rank1a(state, pos, K=K)
    return jnp.take_along_axis(occ, c[:, None].astype(jnp.int32), axis=1)[
        :, 0
    ]


@functools.partial(jax.jit, static_argnames=("K",))
def rank21(state, x, y, c, *, K=None):
    """Single-symbol two-point rank (rld_rank21)."""
    ox, oy = rank2a(state, x, y, K=K)
    ci = c[:, None].astype(jnp.int32)
    return (
        jnp.take_along_axis(ox, ci, axis=1)[:, 0],
        jnp.take_along_axis(oy, ci, axis=1)[:, 0],
    )


@functools.partial(jax.jit, static_argnames=("K", "is_back"))
def extend(state, ik, *, is_back=True, K=None):
    """Batched rld_extend (rld0.c:473-489): one backward (is_back=True) or
    forward extension step of bi-intervals.

    ik: (Q, 3) int — (x0=backward, x1=forward, size).
    Returns ok: (Q, 6, 3) — for each symbol a, the bi-interval of (aP) for
    backward or (Pa~) for forward extension, in the index position dtype."""
    C = _C(state)
    ik = ik.astype(_pos_dtype(state))
    p = ik[:, 0] if is_back else ik[:, 1]
    tk, tl = rank2a(state, p, p + ik[:, 2], K=K)
    size = tl - tk  # (Q, 6)
    same = C[None, :NSYM] + tk  # new x[!is_back] per symbol

    # the other coordinate accumulates in complement order 0,4,3,2,1,5
    # (rld0.c:482-487)
    keep0 = ik[:, 1] if is_back else ik[:, 0]
    other = [None] * NSYM
    other[0] = keep0
    other[4] = other[0] + size[:, 0]
    other[3] = other[4] + size[:, 4]
    other[2] = other[3] + size[:, 3]
    other[1] = other[2] + size[:, 2]
    other[5] = other[1] + size[:, 1]
    other = jnp.stack(other, axis=1)  # (Q, 6)

    if is_back:
        return jnp.stack([same, other, size], axis=2)
    return jnp.stack([other, same, size], axis=2)


@functools.partial(jax.jit, static_argnames=("K",))
def backward_search(state, patterns, lengths, *, K=None):
    """Count occurrences of patterns (as substrings of indexed reads).

    patterns: (Q, Lmax) int32 nt6 codes, aligned to the RIGHT end at column
    Lmax-1 (search proceeds from the last symbol backward); lengths: (Q,).
    Returns (lo, hi): the SA interval per pattern; hi-lo = #occurrences."""
    C = _C(state)
    q, lmax = patterns.shape
    n = C[NSYM]
    pdt = _pos_dtype(state)

    def body(i, carry):
        lo, hi = carry
        col = lmax - 1 - i
        a = patterns[:, col]
        ol, oh = rank2a(state, lo, hi, K=K)
        take = lambda t: jnp.take_along_axis(  # noqa: E731
            t, a[:, None].astype(jnp.int32), axis=1
        ).squeeze(1)
        nlo = C[a] + take(ol)
        nhi = C[a] + take(oh)
        act = i < lengths
        return jnp.where(act, nlo, lo), jnp.where(act, nhi, hi)

    lo = jnp.zeros(q, pdt)
    hi = jnp.full(q, n, pdt)
    lo, hi = jax.lax.fori_loop(0, lmax, body, (lo, hi))
    return lo, hi
