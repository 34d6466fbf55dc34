"""pending_add (index/pending.py) must equal a NumPy model of the merge
of one round's insertions into the sorted pending set: old row i moves to
vp[i] + |{ j : gX[j] <= vp[i] }|, new row j lands at gX[j] + stream[j],
and the rank table counts the merged symbols."""

import numpy as np
import pytest
import jax.numpy as jnp

from ropebwt2_tpu.index.pending import (
    KP,
    PendingIndex,
    _inf,
    pending_add,
    pending_cap,
)
from ropebwt2_tpu.index.rank import build_block_tables


def make_pending(rng, pcap, pfill, nmax, pdt):
    vp = np.full(pcap, int(_inf(pdt)), pdt)
    vp[:pfill] = np.sort(rng.choice(nmax, pfill, replace=False)).astype(pdt)
    psym = np.full(pcap, 6, np.int8)
    psym[:pfill] = rng.integers(0, 6, pfill)
    jp = jnp.asarray(psym)
    return PendingIndex(
        vp=jnp.asarray(vp),
        psym=jp,
        blk_prefix=build_block_tables(jp, KP, dtype=jnp.int32),
        p=jnp.asarray(pfill, jnp.int32),
    ), vp[:pfill], psym[:pfill]


@pytest.mark.parametrize(
    "seed,pfill_frac,M,pdt",
    [(0, 0.3, 4096, np.int32), (1, 0.0, 4096, np.int32),
     (2, 0.9, 4096, np.int32), (3, 0.5, 2048, np.int64),
     (4, 0.0, 1 << 15, np.int32)],
)
def test_pending_add_matches_numpy(seed, pfill_frac, M, pdt):
    rng = np.random.default_rng(seed)
    pcap = pending_cap(M, 4)
    pfill = int((pcap - M) * pfill_frac)
    nmax = 1 << 24
    pend, vp0, ps0 = make_pending(rng, pcap, pfill, nmax, pdt)

    A = int(rng.integers(M // 2, M + 1))
    gX = np.sort(rng.integers(0, nmax, A)).astype(pdt)
    sym = rng.integers(0, 6, A).astype(np.int32)
    order = rng.permutation(M)  # rows arrive in bucket order
    rgX = np.zeros(M, pdt)
    rsym = np.zeros(M, np.int32)
    rstream = np.zeros(M, pdt)
    active = np.zeros(M, bool)
    rgX[order[:A]] = gX
    rsym[order[:A]] = sym
    rstream[order[:A]] = np.arange(A)
    active[order[:A]] = True

    got = pending_add(pend, jnp.asarray(rgX), jnp.asarray(rsym),
                      jnp.asarray(rstream), jnp.asarray(active))

    old_pos = vp0 + np.searchsorted(gX, vp0, side="right")
    new_pos = gX + np.arange(A)
    pos = np.concatenate([old_pos, new_pos])
    syms = np.concatenate([ps0, sym.astype(np.int8)])
    srt = np.argsort(pos, kind="stable")
    p = pfill + A
    assert len(np.unique(pos)) == p
    assert int(got.p) == p
    assert np.array_equal(np.asarray(got.vp)[:p], pos[srt])
    assert np.array_equal(np.asarray(got.psym)[:p], syms[srt])
    assert (np.asarray(got.vp)[p:] == int(_inf(pdt))).all()
    rows = p // KP + 1
    full = np.full(pcap, 6, np.int8)
    full[:p] = syms[srt]
    want_tab = np.asarray(build_block_tables(jnp.asarray(full), KP,
                                             dtype=jnp.int32))
    assert np.array_equal(np.asarray(got.blk_prefix)[:rows], want_tab[:rows])
