"""Communication abstraction for the BCR plan phase.

``plan_round`` (engine/bcr.py) is written against this small interface so
the SAME algorithm runs single-device (LocalComm — the methods are exactly
the ops the tuned single-chip path always used) and sharded under
``shard_map`` (ShardComm — local scans plus explicit carry/boundary
collectives).  This is the distributed re-expression of the reference's
shared-memory BCR round (mrope.c:299-342): the stable bucket sort becomes a
balanced all-to-all re-shard by global sorted rank, scans become
local-scan + carry exchange, and the cross-bucket rebase reductions become
psums.

The padded all-to-all exchanges (one slot row per (source, target) pair,
slot capacity = rows per shard) trade up to D-fold interconnect volume on
a small buffer for fully data-dependent routing with static shapes — the
right trade while the routed payload (a few MB) is far below the link's
bandwidth-delay product.  See HACKING.md for the scaling model.
"""

import jax
import jax.numpy as jnp

from ..index.scan import cummax_blocked, cummin_blocked, cumsum_blocked

I32 = jnp.int32
I64 = jnp.int64


class LocalComm:
    """Single-device implementation: exactly the ops the tuned single-chip
    plan always used (no behavior or performance change)."""

    def iota(self, m):
        return jnp.arange(m, dtype=I32)

    def fetch_syms(self, buf, off):
        """Next-symbol fetch: buf[off] with clipping (single buffer)."""
        return buf[jnp.clip(off, 0, buf.shape[0] - 1)].astype(I32)

    def cumsum(self, x):
        return cumsum_blocked(x)

    def cumsum_with_totals(self, x):
        c = cumsum_blocked(x)
        return c, c[-1]

    def cummax(self, x):
        return cummax_blocked(x)

    def cummin_rev(self, x):
        return cummin_blocked(x, reverse=True)

    def roll1(self, x):
        return jnp.roll(x, 1)

    def shift_up1_bool(self, x, fill):
        return jnp.concatenate(
            [x[1:], jnp.full((1,), fill, x.dtype)]
        )

    def permute(self, dest, arrays):
        dts = {a.dtype for a in arrays}
        # the stacked (M, k) scatter saves per-op overhead; above 2^18 rows
        # the per-array scatters avoid the (M, k) transient
        if len(dts) == 1 and arrays[0].shape[0] <= (1 << 18):
            stacked = jnp.stack(arrays, axis=1)
            out = jnp.zeros_like(stacked).at[dest].set(
                stacked, unique_indices=True
            )
            return [out[:, i] for i in range(len(arrays))]
        return [
            jnp.zeros(a.shape[0], a.dtype).at[dest].set(
                a, unique_indices=True
            )
            for a in arrays
        ]

    def sum_scalar(self, x, dtype):
        return jnp.sum(x, dtype=dtype)

    def max_scalar(self, x):
        return jnp.max(x)

    def psum_array(self, x):
        return x


class ShardComm:
    """shard_map implementation over a 1-D mesh axis.  Every array argument
    is the LOCAL block of a (M,) or (M, C) array sharded along axis 0; all
    methods return local blocks of the corresponding GLOBAL result."""

    def __init__(self, axis, ml, d):
        self.axis = axis
        self.ml = ml  # rows per shard (static)
        self.d = d  # mesh axis size (static python int)
        self.s = jax.lax.axis_index(axis)

    # ---- iota / reductions ----

    def iota(self, m):
        return self.s * self.ml + jnp.arange(self.ml, dtype=I32)

    def sum_scalar(self, x, dtype):
        return jax.lax.psum(jnp.sum(x, dtype=dtype), self.axis)

    def max_scalar(self, x):
        return jax.lax.pmax(jnp.max(x), self.axis)

    def psum_array(self, x):
        return jax.lax.psum(x, self.axis)

    # ---- scans with cross-shard carries ----

    def _carry(self, tots, op, ident, reverse=False):
        """Combine of per-shard totals over shards strictly before (after
        when reverse) this one.  tots: (C,)."""
        allt = jax.lax.all_gather(tots, self.axis)  # (D, C)
        ds = jnp.arange(self.d, dtype=I32)
        mask = (ds > self.s) if reverse else (ds < self.s)
        masked = jnp.where(mask[:, None], allt, ident)
        if op == "sum":
            return masked.sum(axis=0)
        if op == "max":
            return masked.max(axis=0)
        return masked.min(axis=0)

    def cumsum(self, x):
        c, _ = self.cumsum_with_totals(x)
        return c

    def cumsum_with_totals(self, x):
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        loc = cumsum_blocked(x2)
        tots = loc[-1]
        base = self._carry(tots, "sum", jnp.zeros((), x2.dtype))
        out = loc + base[None, :]
        total = jax.lax.psum(tots, self.axis)
        if squeeze:
            return out[:, 0], total[0]
        return out, total

    def cummax(self, x):
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        loc = cummax_blocked(x2)
        ident = jnp.iinfo(x2.dtype).min
        base = self._carry(loc[-1], "max", ident)
        out = jnp.maximum(loc, base[None, :])
        return out[:, 0] if squeeze else out

    def cummin_rev(self, x):
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        loc = cummin_blocked(x2, reverse=True)
        ident = jnp.iinfo(x2.dtype).max
        base = self._carry(loc[0], "min", ident, reverse=True)
        out = jnp.minimum(loc, base[None, :])
        return out[:, 0] if squeeze else out

    # ---- boundary exchange ----

    def _from_left(self, row):
        """row: (1, C) last row of each shard; returns left neighbor's (the
        first shard receives zeros — callers mask row 0 anyway)."""
        return jax.lax.ppermute(
            row, self.axis, [(i, i + 1) for i in range(self.d - 1)]
        )

    def _from_right(self, row):
        return jax.lax.ppermute(
            row, self.axis, [(i + 1, i) for i in range(self.d - 1)]
        )

    def roll1(self, x):
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        prev = self._from_left(x2[-1:])
        out = jnp.concatenate([prev, x2[:-1]], axis=0)
        return out[:, 0] if squeeze else out

    def shift_up1_bool(self, x, fill):
        x32 = x.astype(I32)  # ppermute int payload, bool result
        nxt = self._from_right(x32[:1][:, None])[:, 0]
        # the LAST shard's last row takes the fill value
        nxt = jnp.where(self.s == self.d - 1, jnp.asarray(fill, I32), nxt)
        return jnp.concatenate([x32[1:], nxt]) != 0

    # ---- routed next-symbol fetch (sharded read buffer) ----

    def fetch_syms(self, buf, off):
        """buf is the LOCAL block of the read buffer (sharded by byte
        range); each row's next symbol is fetched from the shard owning
        its offset via a slot-capped exchange.  Reads keep their global
        byte offsets, so routing is a fixed division; offsets of a random
        batch spread near-uniformly over the buffer shards."""
        lbuf = buf.shape[0]
        q = off.shape[0]
        tgt = jnp.clip(off // lbuf, 0, self.d - 1).astype(I32)
        s_cap = None
        if self.d > 1:
            s_cap = min(q, -(-(4 * q // self.d) // 256) * 256)
        rv, (roff,), route = self.exchange(
            tgt, jnp.ones(q, bool), [off], slot_cap=s_cap
        )
        loc = jnp.clip(
            roff - self.s.astype(off.dtype) * lbuf, 0, lbuf - 1
        )
        ans = buf[loc].astype(I32)
        return self.reply(route, ans)

    # ---- padded all-to-all routing ----

    def _slots(self, tgt):
        """slot[i] = rank of row i among local rows with the same target
        (targets in [0, D); padding rows must carry target D-1 or a valid
        target — they are dropped by the validity channel, not here)."""
        slot = jnp.zeros(tgt.shape[0], I32)
        for t in range(self.d):
            oh = (tgt == t).astype(I32)
            slot = slot + oh * (cumsum_blocked(oh) - 1)
        return slot

    def exchange(self, tgt, valid, payload, slot_cap=None):
        """Route rows to target shards.  payload: list of (Q,) arrays.
        Returns (recv_valid (D*Q,) bool, recv list of (D*Q,) arrays,
        tgt, slot) — receivers see one Q-slot block per source shard;
        (tgt, slot) lets the caller route replies back with ``reply``.

        ``slot_cap`` = S < Q enables CONCENTRATION-AWARE slots: the
        all_to_all ships only S rows per (src, tgt) pair (volume
        D*S instead of the worst-case D*Q), falling back to the full
        exchange — compiled but rarely executed — when any shard would
        overflow (the predicate is psum'd, so every shard takes the same
        branch: SPMD-safe).  Use for near-uniform routings (rank/insert
        routes of random batches: expected rows per pair = Q/D); keep
        the default for adversarial ones (the sort re-shard, where a
        sorted block maps to a contiguous range on ~one target)."""
        q = tgt.shape[0]
        slot = self._slots(tgt)

        def ship(cap):
            idx = tgt * cap + slot
            oob = jnp.where(valid & (slot < cap), idx, self.d * cap)
            vmask = jnp.zeros(self.d * cap, bool).at[oob].set(
                True, mode="drop", unique_indices=True
            )
            sends = [
                jnp.zeros(self.d * cap, p.dtype).at[oob].set(
                    p, mode="drop", unique_indices=True
                )
                for p in payload
            ]
            rv = jax.lax.all_to_all(
                vmask.reshape(self.d, cap), self.axis, 0, 0
            ).reshape(-1)
            rc = [
                jax.lax.all_to_all(
                    s.reshape(self.d, cap), self.axis, 0, 0
                ).reshape(-1)
                for s in sends
            ]
            return rv, rc

        if slot_cap is None or slot_cap >= q:
            recv_valid, recv = ship(q)
            return recv_valid, recv, (tgt, slot, None)

        s_cap = slot_cap
        over = jax.lax.psum(
            jnp.sum(valid & (slot >= s_cap), dtype=I32), self.axis
        )

        def fast():
            rv, rc = ship(s_cap)
            # embed (D, S) blocks into the (D, Q) receiver layout with a
            # static pad — consumers keep indexing rows as src*Q + slot
            pad = lambda a: jnp.pad(  # noqa: E731
                a.reshape(self.d, s_cap), ((0, 0), (0, q - s_cap))
            ).reshape(self.d * q)
            return pad(rv), [pad(r) for r in rc]

        def slow():
            return ship(q)

        recv_valid, recv = jax.lax.cond(over == 0, fast, slow)
        return recv_valid, recv, (tgt, slot, s_cap, over)

    def reply(self, route, answers):
        """Inverse routing of ``exchange``: ``answers`` are (D*Q, ...)
        arrays indexed like recv; returns each original row's answer.
        Mirrors the slot-capped fast path when the exchange used one."""
        tgt, slot = route[0], route[1]
        q = tgt.shape[0]

        def ship_back(ans, cap):
            return jax.lax.all_to_all(
                ans, self.axis, 0, 0
            ).reshape((self.d * cap,) + answers.shape[1:])

        full = answers.reshape((self.d, q) + answers.shape[1:])
        if len(route) == 2 or route[2] is None:
            back = ship_back(full, q)
            return back[tgt * q + slot]
        s_cap, over = route[2], route[3]

        def fast():
            small = ship_back(full[:, :s_cap], s_cap)
            # small rows live at src*S + slot; re-embed to src*Q + slot
            sm = small.reshape((self.d, s_cap) + answers.shape[1:])
            widths = [(0, 0), (0, q - s_cap)] + [
                (0, 0) for _ in answers.shape[1:]
            ]
            return jnp.pad(sm, widths).reshape(
                (self.d * q,) + answers.shape[1:]
            )

        def slow():
            return ship_back(full, q)

        back = jax.lax.cond(over == 0, fast, slow)
        return back[tgt * q + slot]

    def permute(self, dest, arrays):
        """Global permutation: row i (local) moves to global position
        dest[i]; every global position receives exactly one row.  Returns
        local blocks of the permuted arrays."""
        tgt = (dest // self.ml).astype(I32)
        valid = jnp.ones(dest.shape[0], bool)
        lo = self.s.astype(dest.dtype) * self.ml
        rv, recv, _ = self.exchange(
            tgt, valid, list(arrays) + [dest]
        )
        rdest = recv[-1]
        ldest = jnp.where(rv, rdest - lo, self.ml)
        out = []
        for r in recv[:-1]:
            out.append(
                jnp.zeros(self.ml, r.dtype).at[ldest].set(
                    r, mode="drop", unique_indices=True
                )
            )
        return out
