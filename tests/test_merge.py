"""The flat-tier merge must equal np.insert on the live prefix, and its
rank table must equal a fresh count of the merged bytes.

Both implementations run on every case: the plain XLA formulation
(index/merge.py apply_insertions + index/rank.py build_block_tables) and
the GPU kernel (index/merge_gpu.py) in Pallas interpret mode.  Content
past the live prefix is unspecified for both, and input bytes past ``n``
may hold garbage.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from ropebwt2_tpu.index.merge import apply_insertions
from ropebwt2_tpu.index.merge_gpu import TILE, merge_flat, merge_kernel_applies
from ropebwt2_tpu.index.rank import build_block_tables


def _rows(rng, M, pos, sym, perm=True):
    """Scatter A sorted insertions into M rows in random row order (the
    engine's rows arrive in bucket order, not stream order)."""
    A = len(pos)
    order = rng.permutation(M) if perm else np.arange(M)
    P = np.zeros(M, np.int64)
    S = np.zeros(M, np.int32)
    T = np.zeros(M, np.int64)
    V = np.zeros(M, bool)
    P[order[:A]] = pos
    S[order[:A]] = sym
    T[order[:A]] = np.arange(A)
    V[order[:A]] = True
    return P, S, T, V


def _case(name, rng):
    """(cap, n, K, pos, sym, M, garbage_tail) for one named scenario."""
    if name.startswith("random"):
        cap, K, M = 16384, 256, 64
        n = int(rng.integers(0, cap - M))
        A = int(rng.integers(0, M + 1))
        return cap, n, K, np.sort(rng.integers(0, n + 1, A)), M, \
            name.endswith("garbage")
    if name.startswith("multitile"):
        K = int(name.split("-k")[1])
        cap, M = 32768, 256
        n = cap - M - 7
        return cap, n, K, np.sort(rng.integers(0, n + 1, M)), M, False
    if name == "dense-clustered":
        cap, K, M, n = 16384, 256, 4096, 1000
        return cap, n, K, np.sort(rng.integers(0, 50, M)), M, False
    if name == "fully-dense-tile":
        # the first tiles hold nothing but insertions; later ones are
        # insertion-dominant with odd offsets
        cap, K, M, n = 32768, 256, 8192, 9000
        pos = np.sort(np.concatenate([
            np.zeros(5000, np.int64), rng.integers(0, 4000, M - 5000)]))
        return cap, n, K, pos, M, True
    if name == "sparse-ends":
        cap, K, M, n = 16384, 256, 32, 9000
        return cap, n, K, np.array([0, n]), M, False
    if name == "empty":
        cap, K, M, n = 16384, 256, 32, 7000
        return cap, n, K, np.zeros(0, np.int64), M, False
    if name == "tail-tile-untouched":
        # every insertion lands far below the last live tile
        cap, K, M, n = 16384, 256, 16, 16000
        return cap, n, K, np.array([9000]), M, False
    if name == "from-empty":
        cap, K, M, n = 8192, 128, 3000, 0
        return cap, n, K, np.zeros(M, np.int64), M, False
    raise KeyError(name)


CASES = [
    "random-0", "random-1-garbage", "random-2", "random-3-garbage",
    "multitile-k128", "multitile-k256", "dense-clustered",
    "fully-dense-tile", "sparse-ends", "empty", "tail-tile-untouched",
    "from-empty",
]


@pytest.mark.parametrize("impl", ["plain", "kernel-interpret"])
@pytest.mark.parametrize("name", CASES)
def test_flat_merge_matches_np_insert(name, impl):
    rng = np.random.default_rng(CASES.index(name))
    cap, n, K, pos, M, garbage = _case(name, rng)
    bwt = np.full(cap, 6, np.int8)
    bwt[:n] = rng.integers(0, 6, n)
    if garbage:
        bwt[n:] = rng.integers(-128, 127, cap - n)
    sym = rng.integers(0, 6, len(pos))
    want = np.insert(bwt[:n], pos, sym.astype(np.int8))
    live = len(want)

    jb = jnp.asarray(bwt)
    args = [jnp.asarray(x) for x in _rows(rng, M, pos, sym)]
    if impl == "plain":
        got = apply_insertions(jb, jnp.asarray(n), *args)
        tab = build_block_tables(got, K, dtype=jnp.int32)
    else:
        got, tab = merge_flat(jb, jnp.asarray(n, jnp.int64), *args, K=K,
                              dtype=jnp.int32, interpret=True)
    got = np.asarray(got)
    assert np.array_equal(got[:live], want)
    rows = live // K + 1  # table rows at or below the live prefix
    counts = (want[: (rows - 1) * K].reshape(rows - 1, K)[:, :, None]
              == np.arange(6)[None, None, :]).sum(axis=1)
    want_tab = np.concatenate([np.zeros((1, 6), np.int64),
                               np.cumsum(counts, axis=0)])
    assert np.asarray(tab).dtype == np.int32
    assert np.array_equal(np.asarray(tab)[:rows], want_tab)


def test_merge_kernel_gate():
    """The kernel needs the GPU, int32 positions over the whole
    allocation, and K-blocks that tile a kernel tile."""
    assert not merge_kernel_applies(1 << 20, 128)  # the CPU backend
    import jax

    assert jax.default_backend() == "cpu"
    assert TILE % 128 == 0 and TILE & (TILE - 1) == 0
