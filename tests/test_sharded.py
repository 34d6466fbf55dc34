"""shard_map multi-device BCR must match the single-device engine exactly
(on the virtual 8-device CPU mesh)."""

import numpy as np
import pytest

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.oracle import SO_IO, SO_RCLO, SO_RLO

from conftest import random_reads


def _make(so):
    import jax
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    return ShardedTpuBwt(so=so, K=256)


@pytest.mark.parametrize("so", [SO_IO, SO_RLO, SO_RCLO])
def test_sharded_matches_single_device(so, rng):
    reads = random_reads(rng, n=40, lo=4, hi=25, with_n=True)
    single = TpuBwt(so=so, K=256)
    single.insert_multi(reads)
    sharded = _make(so)
    sharded.insert_multi(reads)
    assert np.array_equal(sharded.bwt_array(), single.bwt_array())
    assert np.array_equal(sharded.counts(), single.counts())


def test_sharded_cli(ref_binary, rng):
    """CLI with ROPEBWT2_TPU_SHARDED=1 on the virtual mesh matches the
    reference byte-for-byte."""
    import os
    import subprocess
    import sys

    from conftest import reads_to_lines, run_ref

    reads = random_reads(rng, n=25, lo=4, hi=15)
    data = reads_to_lines(reads)
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        ROPEBWT2_TPU_SHARDED="1",
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", "-LRs", "-"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=repo, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    assert b"sharded engine over 8 devices" in r.stderr
    assert r.stdout == run_ref(ref_binary, ["-LRs", "-"], data)


def test_sharded_incremental_batches(rng):
    reads = random_reads(rng, n=60, lo=4, hi=20)
    single = TpuBwt(so=SO_RLO, K=256)
    single.insert_multi(reads)
    sharded = _make(SO_RLO)
    sharded.insert_multi(reads[:25])
    sharded.insert_multi(reads[25:])
    assert np.array_equal(sharded.bwt_array(), single.bwt_array())


def test_shardcomm_primitives_vs_numpy():
    """Unit-level checks of the collective building blocks (scans with
    carries, boundary rolls, the padded exchange/reply, the sort
    permutation) against numpy on the 8-device mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from ropebwt2_tpu.parallel.comm import ShardComm

    d = 8
    m = 8 * 256
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("s",))
    rng = np.random.default_rng(2)
    x = rng.integers(0, 50, size=(m, 3)).astype(np.int32)
    v = rng.integers(0, 40, size=m).astype(np.int32)
    dest = rng.permutation(m).astype(np.int32)
    q = rng.integers(0, m, size=m).astype(np.int32)  # routed values

    def body(xl, vl, dl, ql):
        comm = ShardComm("s", m // d, d)
        outs = {}
        outs["iota"] = comm.iota(m // d)
        outs["cumsum"], outs["tot"] = comm.cumsum_with_totals(xl)
        outs["cummax"] = comm.cummax(xl)
        outs["cummin_rev"] = comm.cummin_rev(xl)
        outs["roll1"] = comm.roll1(vl)
        outs["shiftup"] = comm.shift_up1_bool(vl > 20, True).astype(
            jnp.int32
        )
        outs["perm"] = comm.permute(dl, (vl, vl * 2 + 1))[1]
        # route each value to shard q // (m//d); owners add s_idx*1000;
        # replies must land back at the original rows
        tgt = (ql // (m // d)).astype(jnp.int32)
        rv, (rq,), route = comm.exchange(
            tgt, jnp.ones(ql.shape[0], bool), [ql]
        )
        ans = jnp.where(rv, rq + comm.s * 1000, -1)
        outs["routed"] = comm.reply(route, ans)
        # slot-capped variant with slot_cap STRICTLY below q so the capped
        # fast branch (and reply's s_cap-width ship_back) actually executes
        # — random targets keep every (src,tgt) pair far under q//2 slots
        rv2, (rq2,), route2 = comm.exchange(
            tgt, jnp.ones(ql.shape[0], bool), [ql],
            slot_cap=ql.shape[0] // 2,
        )
        ans2 = jnp.where(rv2, rq2 + comm.s * 1000, -1)
        outs["routed_capped"] = comm.reply(route2, ans2)
        # adversarial concentration: every row to shard 0 overflows the
        # same sub-q cap, forcing the psum'd slow fallback to execute
        tgt0 = jnp.zeros_like(tgt)
        rv3, (rq3,), route3 = comm.exchange(
            tgt0, jnp.ones(ql.shape[0], bool), [ql],
            slot_cap=ql.shape[0] // 2,
        )
        ans3 = jnp.where(rv3, rq3 * 2 + 7, -1)
        outs["routed_overflow"] = comm.reply(route3, ans3)
        outs["sum"] = jnp.broadcast_to(
            comm.sum_scalar(vl, jnp.int64), (m // d,)
        )
        return tuple(outs[k] for k in sorted(outs))

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("s"), P("s"), P("s"), P("s")),
        out_specs=tuple([P("s")] * 12),
        check_vma=False,
    )
    keys = sorted([
        "iota", "cumsum", "tot", "cummax", "cummin_rev", "roll1",
        "shiftup", "perm", "routed", "routed_capped", "routed_overflow",
        "sum",
    ])
    got = dict(zip(keys, fn(jnp.asarray(x), jnp.asarray(v),
                            jnp.asarray(dest), jnp.asarray(q))))
    assert np.array_equal(got["iota"], np.arange(m))
    assert np.array_equal(got["cumsum"], np.cumsum(x, axis=0))
    assert np.array_equal(np.asarray(got["tot"]).reshape(d, 3)[0],
                          x.sum(axis=0))
    assert np.array_equal(got["cummax"], np.maximum.accumulate(x, axis=0))
    assert np.array_equal(
        got["cummin_rev"], np.minimum.accumulate(x[::-1], axis=0)[::-1]
    )
    assert np.array_equal(np.asarray(got["roll1"])[1:], v[:-1])
    want_shift = np.concatenate([(v > 20)[1:], [True]]).astype(np.int32)
    assert np.array_equal(got["shiftup"], want_shift)
    want_perm = np.empty(m, np.int32)
    want_perm[dest] = v * 2 + 1
    assert np.array_equal(got["perm"], want_perm)
    assert np.array_equal(
        got["routed"], q + (q // (m // d)) * 1000
    )
    assert np.array_equal(
        got["routed_capped"], q + (q // (m // d)) * 1000
    )
    assert np.array_equal(got["routed_overflow"], q * 2 + 7)
    assert int(np.asarray(got["sum"])[0]) == int(v.sum())


def test_sharded_restore_from_single(rng):
    """FMR -i restore into the sharded engine: adopt a single-device index,
    insert more batches, match an all-single-device build byte-for-byte."""
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    reads = random_reads(rng, n=48, lo=4, hi=20)
    base = TpuBwt(so=SO_RLO, K=256)
    base.insert_multi(reads[:24])

    sharded = _make(SO_RLO)
    sharded = ShardedTpuBwt.from_single(base, mesh=sharded.mesh)
    # export works immediately after restore (no batch inserted yet)
    assert int(sharded.counts()[0]) == 24
    sharded.insert_multi(reads[24:])

    single = TpuBwt(so=SO_RLO, K=256)
    single.insert_multi(reads[:24])
    single.insert_multi(reads[24:])
    assert np.array_equal(sharded.bwt_array(), single.bwt_array())
    assert np.array_equal(sharded.counts(), single.counts())


def test_sharded_cli_restore(ref_binary, rng, tmp_path):
    """CLI -i FILE with ROPEBWT2_TPU_SHARDED=1: restore + incremental build
    must match the reference binary doing the same two-step build."""
    import os
    import subprocess
    import sys

    from conftest import reads_to_lines, run_ref

    reads = random_reads(rng, n=30, lo=4, hi=15)
    d1 = reads_to_lines(reads[:15])
    d2 = reads_to_lines(reads[15:])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        ROPEBWT2_TPU_SHARDED="1",
    )
    fmr = str(tmp_path / "step1.fmr")
    r1 = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", "-LRsb", "-o", fmr, "-"],
        input=d1, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=repo, env=env,
    )
    assert r1.returncode == 0, r1.stderr.decode()
    r2 = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", "-LR", "-i", fmr, "-"],
        input=d2, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=repo, env=env,
    )
    assert r2.returncode == 0, r2.stderr.decode()
    assert b"sharded engine over 8 devices" in r2.stderr

    ref_fmr = str(tmp_path / "ref.fmr")
    run_ref(ref_binary, ["-LRsb", "-o", ref_fmr, "-"], d1)
    want = run_ref(ref_binary, ["-LR", "-i", ref_fmr, "-"], d2)
    assert r2.stdout == want


def test_multihost_2d_mesh_parity(rng):
    """2x4 (host, shard) mesh: the engine over the flattened axis tuple
    must match the single-device build byte-for-byte (SURVEY.md §7.7 —
    the virtual-host analogue of a 2-host x 4-chip pod slice)."""
    import jax

    from ropebwt2_tpu.parallel.mesh import make_mesh2d
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh2d(2, 4)
    reads = random_reads(rng, n=48, lo=4, hi=22, with_n=True)
    single = TpuBwt(so=SO_RLO, K=256)
    single.insert_multi(reads)
    eng = ShardedTpuBwt(so=SO_RLO, K=256, mesh=mesh)
    eng.insert_multi(reads[:20])
    eng.insert_multi(reads[20:])
    assert np.array_equal(eng.bwt_array(), single.bwt_array())
    assert np.array_equal(eng.counts(), single.counts())


@pytest.mark.parametrize("so", [SO_IO, SO_RLO, SO_RCLO])
def test_sharded_deferred_parity(so, rng):
    """Deferred-merge sharded path (per-shard pending, V-interval routing,
    spill-shipping flush) must be byte-identical to the single-device
    engine on the 8-device mesh, across incremental batches."""
    import jax
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    reads = random_reads(rng, n=72, lo=4, hi=24, with_n=True)
    single = TpuBwt(so=so, K=256)
    single.insert_multi(reads[:40])
    single.insert_multi(reads[40:])
    eng = ShardedTpuBwt(so=so, K=256, defer_r=4)
    eng.insert_multi(reads[:40])
    eng.insert_multi(reads[40:])
    assert np.array_equal(eng.bwt_array(), single.bwt_array())
    assert np.array_equal(eng.counts(), single.counts())


def test_sharded_deferred_2d_mesh(rng):
    """Deferred sharded path over the 2-D (host, shard) mesh."""
    import jax
    from ropebwt2_tpu.parallel.mesh import make_mesh2d
    from ropebwt2_tpu.parallel.sharded import ShardedTpuBwt

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    reads = random_reads(rng, n=40, lo=5, hi=18)
    single = TpuBwt(so=SO_RLO, K=256)
    single.insert_multi(reads)
    eng = ShardedTpuBwt(so=SO_RLO, K=256, mesh=make_mesh2d(2, 4),
                        defer_r=4)
    eng.insert_multi(reads)
    assert np.array_equal(eng.bwt_array(), single.bwt_array())


@pytest.mark.parametrize("s_lo", [0, 5, 700])
def test_stitched_merge_matches_numpy(s_lo):
    """The sharded engine's per-shard merge: the window's insertions plus
    the rightward drift of s_lo symbols from lower shards, read from the
    left neighbor's tail."""
    import jax.numpy as jnp
    from ropebwt2_tpu.parallel.sharded import stitched_merge

    rng = np.random.default_rng(s_lo)
    lcap, m = 98304, 32768
    bwt_loc = rng.integers(0, 6, lcap).astype(np.int8)
    tail = rng.integers(0, 6, m).astype(np.int8)
    A = 90
    dst = np.sort(rng.choice(lcap - m, A, replace=False))
    ldest = np.full(m, lcap, np.int64)  # out-of-window rows are dropped
    ldest[:A] = dst
    rsym = np.zeros(m, np.int32)
    rsym[:A] = rng.integers(0, 6, A)

    # the window is the global sequence (tail + window, shifted right by
    # s_lo) with this shard's insertions placed at their destinations
    stream = np.concatenate([tail, bwt_loc])[m - s_lo : m - s_lo + lcap]
    want = np.empty(lcap, np.int8)
    mark = np.zeros(lcap, bool)
    mark[dst] = True
    want[mark] = rsym[:A]
    want[~mark] = stream[: lcap - A]
    got = stitched_merge(jnp.asarray(bwt_loc), jnp.asarray(tail),
                         jnp.asarray(ldest), jnp.asarray(rsym),
                         jnp.asarray(s_lo, np.int32))
    assert np.array_equal(np.asarray(got), want)
