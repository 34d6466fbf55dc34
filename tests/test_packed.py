"""4-bit packed storage: round-trip, two-level tables, packed rank, and
packed merge must agree exactly with the int8 formulation."""

import numpy as np
import pytest
import jax.numpy as jnp

from ropebwt2_tpu.index.packed import (
    apply_insertions_packed,
    build_two_level_tables,
    pack_bwt,
    pack_bwt_np,
    rank_global_packed,
    unpack_bwt,
    unpack_bwt_np,
)
from ropebwt2_tpu.index.merge import apply_insertions
from ropebwt2_tpu.index.rank import build_block_tables, rank_global


def test_pack_roundtrip(rng):
    n = 512 * 128
    syms = rng.integers(0, 7, n).astype(np.int8)
    p = pack_bwt_np(syms)
    assert np.array_equal(unpack_bwt_np(p), syms)
    jp = np.asarray(pack_bwt(jnp.asarray(syms)))
    assert np.array_equal(jp, p)
    assert np.array_equal(np.asarray(unpack_bwt(jnp.asarray(p))), syms)


def test_packed_rank_matches_int8(rng):
    cap = 1 << 16
    n = cap - 300
    syms = np.full(cap, 6, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    pb = jnp.asarray(pack_bwt_np(syms))
    blkA, blkB = build_two_level_tables(pb, cap)
    blk = build_block_tables(jnp.asarray(syms), 128, dtype=jnp.int64)
    pos = np.concatenate(
        [rng.integers(0, n + 1, 500), [0, 1, 127, 128, 129, 255, 256, n]]
    ).astype(np.int64)
    want = np.asarray(rank_global(jnp.asarray(syms), blk, jnp.asarray(pos), 128))
    got = np.asarray(rank_global_packed(pb, blkA, blkB, jnp.asarray(pos)))
    assert np.array_equal(got, want)


def test_packed_merge_matches_int8(rng):
    cap = 1 << 15
    n = cap - 2048
    syms = np.full(cap, 6, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    M, A = 128, 100
    pos = np.zeros(M, np.int64)
    pos[:A] = np.sort(rng.integers(0, n + 1, A))
    sym = np.zeros(M, np.int32)
    sym[:A] = rng.integers(0, 6, A)
    stream = np.zeros(M, np.int64)
    stream[:A] = np.arange(A)
    valid = np.zeros(M, bool)
    valid[:A] = True
    jargs = [jnp.asarray(x) for x in (pos, sym, stream, valid)]
    want = np.asarray(
        apply_insertions(jnp.asarray(syms), jnp.asarray(n), *jargs)
    )
    got_p = apply_insertions_packed(
        jnp.asarray(pack_bwt_np(syms)), jnp.asarray(n), *jargs
    )
    got = unpack_bwt_np(np.asarray(got_p))
    lim = n + A
    assert np.array_equal(got[:lim], want[:lim])


def test_two_level_anchor_boundaries(rng):
    """Anchor arithmetic at the 2^24 chunk boundary (simulated with a
    capacity above one chunk would be 16 Msym; instead verify the anchor
    formula by consistency: A[a] + B[blk] == absolute prefix counts)."""
    cap = 1 << 16
    syms = rng.integers(0, 6, cap).astype(np.int8)
    pb = jnp.asarray(pack_bwt_np(syms))
    blkA, blkB = build_two_level_tables(pb, cap)
    from ropebwt2_tpu.index.packed import blkb_row

    want = np.asarray(build_block_tables(jnp.asarray(syms), 128,
                                         dtype=jnp.int64))
    blks = np.arange(cap // 128 + 1)
    rows = np.asarray(blkb_row(blks, cap // 256))
    got = np.asarray(blkA)[(blks * 128) >> 24] + np.asarray(blkB)[rows]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("trial", range(4))
def test_packed_merge_matches_np_insert(trial):
    """The packed-tier merge (apply_insertions_packed) plus its two-level
    tables must equal np.insert and a fresh count on the live prefix;
    odd trials carry garbage nibbles past n."""
    import jax.numpy as jnp
    from ropebwt2_tpu.index.packed import (
        apply_insertions_packed, blkb_row, build_two_level_tables,
    )

    rng = np.random.default_rng(trial)
    CAP, M = 32768, 96
    n = int(rng.integers(1, CAP - M))
    syms = np.full(CAP, 6, np.int8)
    syms[:n] = rng.integers(0, 6, n)
    if trial % 2:
        syms[n:] = rng.integers(0, 16, CAP - n)
    pb = pack_bwt_np(syms)
    A = int(rng.integers(1, M + 1))
    ins = np.sort(rng.integers(0, n + 1, A))
    isym = rng.integers(0, 6, A)
    order = rng.permutation(M)
    pos = np.zeros(M, np.int64)
    sym = np.zeros(M, np.int32)
    stream = np.zeros(M, np.int64)
    valid = np.zeros(M, bool)
    pos[order[:A]] = ins
    sym[order[:A]] = isym
    stream[order[:A]] = np.arange(A)
    valid[order[:A]] = True
    jargs = [jnp.asarray(x) for x in (pos, sym, stream, valid)]

    got_p = apply_insertions_packed(jnp.asarray(pb), jnp.asarray(n), *jargs)
    blkA, blkB = build_two_level_tables(got_p, CAP)
    want = np.insert(syms[:n], ins, isym.astype(np.int8))
    lim = n + A
    got = unpack_bwt_np(np.asarray(got_p))
    assert np.array_equal(got[:lim], want)

    limk = lim // 128
    cnt = (want[: limk * 128].reshape(limk, 128)[:, :, None]
           == np.arange(6)[None, None, :]).sum(axis=1)
    want_tab = np.concatenate([np.zeros((1, 6), np.int64),
                               np.cumsum(cnt, axis=0)])
    blks = np.arange(limk + 1)
    rows = np.asarray(blkb_row(blks, CAP // 256))
    got_tab = np.asarray(blkA)[(blks * 128) >> 24] + np.asarray(blkB)[rows]
    assert np.array_equal(got_tab, want_tab)
