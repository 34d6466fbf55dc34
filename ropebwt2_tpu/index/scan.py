"""Blocked prefix sums.

Cumsum within B-element windows as a lower-triangular f32 matmul (exact
for window sums <= 2^24 at HIGHEST precision), then a recursive integer
prefix sum of the window totals, broadcast back as bases.  Small axes use
Hillis-Steele shift-adds.
"""

import jax
import jax.numpy as jnp
import numpy as np

_B = 256
_LEAF = 1024  # below this, shift-add scan on the whole axis


def cumsum_small(x, axis=0):
    """Inclusive prefix sum via Hillis-Steele shift-adds — O(n log n)
    elementwise adds, for small axes."""
    n = x.shape[axis]
    shift = 1
    while shift < n:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (shift, 0)
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n - shift)
        x = x + jnp.pad(x[tuple(sl)], pad)
        shift <<= 1
    return x


def _cummax_small(x, axis=0, reverse=False, op=jnp.maximum):
    """Inclusive prefix max (min with op=jnp.minimum) via Hillis-Steele
    shift-combines."""
    n = x.shape[axis]
    shift = 1
    while shift < n:
        sl = [slice(None)] * x.ndim
        if reverse:
            sl[axis] = slice(shift, n)
            shifted = x[tuple(sl)]
            keep = [slice(None)] * x.ndim
            keep[axis] = slice(0, n - shift)
            upd = op(x[tuple(keep)], shifted)
            x = jnp.concatenate(
                [upd, x[tuple([slice(None)] * (axis) + [slice(n - shift, n)])]],
                axis=axis,
            )
        else:
            sl[axis] = slice(0, n - shift)
            shifted = x[tuple(sl)]
            keep = [slice(None)] * x.ndim
            keep[axis] = slice(shift, n)
            upd = op(x[tuple(keep)], shifted)
            x = jnp.concatenate(
                [x[tuple([slice(None)] * (axis) + [slice(0, shift)])], upd],
                axis=axis,
            )
        shift <<= 1
    return x


def cummax_blocked(x, reverse=False, op=None):
    """Inclusive prefix max along axis 0 of (M,) or (M, C) integer arrays;
    reverse=True scans from the end (suffix max).  Two-level: Hillis-Steele
    within 256-element windows vectorized across windows, then a recursive
    scan of window totals.  Pass op=jnp.minimum for cummin."""
    if op is None:
        op = jnp.maximum
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    m, c = x.shape
    if m <= _LEAF or m % _B != 0:
        out = _cummax_small(x, axis=0, reverse=reverse, op=op)
        return out[:, 0] if squeeze else out
    nb = m // _B
    xb = x.reshape(nb, _B, c)
    inner = _cummax_small(xb, axis=1, reverse=reverse, op=op)
    totals = inner[:, 0 if reverse else -1, :]  # (nb, c)
    tot_scan = cummax_blocked(totals, reverse=reverse, op=op)
    info = jnp.iinfo(x.dtype)
    ident = jnp.full((1, c), info.min if op is jnp.maximum else info.max,
                     x.dtype)
    # window w combines with the scan of totals strictly before (after) it;
    # the first (last) window combines with the identity
    if reverse:
        bases = jnp.concatenate([tot_scan[1:], ident])
    else:
        bases = jnp.concatenate([ident, tot_scan[:-1]])
    out = op(inner, bases[:, None, :]).reshape(m, c)
    return out[:, 0] if squeeze else out


def cummin_blocked(x, reverse=False):
    return cummax_blocked(x, reverse=reverse, op=jnp.minimum)


def cumsum_blocked(x, exact=False):
    """Inclusive prefix sum along axis 0 of an integer array shaped (M,) or
    (M, C).  M must be a multiple of 256 unless M <= leaf size.

    The matmul path computes 256-element window sums in f32, exact only while
    they stay below 2^24 at every level of the recursion (the second level
    sums 65536 input elements) — fine for one-hot/count inputs bounded by
    the block length.  Pass exact=True when single elements can be large
    (e.g. per-position insertion multiplicities): windows then use an
    integer shift-add scan instead."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    out = _cumsum2d(x, exact)
    return out[:, 0] if squeeze else out


# Every exactness-critical f32 contraction in this codebase — the window
# tri-matmul here, the plan's one-hot selects — pins precision=HIGHEST
# (true f32: exact for values < 2^24).  The default precision may run f32
# dots with reduced-precision operands (TF32 on the GPU keeps 10 mantissa
# bits), which rounds integers above 2^11.
_EXACT = jax.lax.Precision.HIGHEST


def _cumsum2d(x, exact=False):
    m, c = x.shape
    if m <= _LEAF or m % _B != 0:
        if x.dtype == jnp.int64 or m % _B != 0:
            return cumsum_small(x, axis=0)
        # jnp.cumsum promotes int32 -> int64 under x64; keep the dtype
        return jnp.cumsum(x, axis=0).astype(x.dtype)
    nb = m // _B
    xb = x.reshape(nb, _B, c)
    if exact:
        inner = cumsum_small(xb, axis=1)
    else:
        tri = jnp.tril(jnp.ones((_B, _B), jnp.float32))
        # window-local inclusive prefix sums; exact: window sums <= 2^24
        inner = jnp.einsum(
            "ij,bjc->bic", tri, xb.astype(jnp.float32), precision=_EXACT
        ).astype(x.dtype)
    totals = inner[:, -1, :]  # (nb, c)
    bases = jnp.concatenate(
        [jnp.zeros((1, c), x.dtype), _cumsum2d(totals, exact)[:-1]]
    )
    return (inner + bases[:, None, :]).reshape(m, c)
