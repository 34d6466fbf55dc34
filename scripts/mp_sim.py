"""True multi-process (multi-controller) simulation of the sharded BCR
batch program — the CPU stand-in for a multi-host cluster (SURVEY.md
§7.7): two OS processes, each owning 4 CPU devices, federate via
jax.distributed into one 2x4 (host, shard) mesh and run
sharded_bcr_batch on it.  Each process then checks ITS OWN addressable
shards byte-for-byte against a locally computed single-device build (no
cross-process gather needed — both processes derive the same expected
BWT from the same seed).

Launch (both from the test driver, tests/test_multiprocess.py):
    python scripts/mp_sim.py <process_id> <coordinator_port>
Prints "MPSIM OK <pid>" on success.

Env: JAX_PLATFORMS=cpu JAX_NUM_CPU_DEVICES=4.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    import jax

    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert len(jax.devices()) == 8, jax.devices()
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ropebwt2_tpu.engine import TpuBwt
    from ropebwt2_tpu.engine.bcr import ReadStates, _pad_pow2, _round_up
    from ropebwt2_tpu.index.flat import PAD
    from ropebwt2_tpu.index.rank import build_block_tables
    from ropebwt2_tpu.parallel.sharded import (
        ShardedBwt,
        sharded_bcr_batch,
    )

    D, K = 8, 256
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("h", "s"))
    rng = np.random.default_rng(4)
    reads = [rng.integers(1, 6, size=int(ln)).astype(np.int8)
             for ln in rng.integers(4, 24, size=64)]

    # expected result: single-device build (local devices only)
    single = TpuBwt(so=1, K=K)
    single.insert_multi(reads)
    want = single.bwt_array()

    # global inputs, built identically in both processes
    m = len(reads)
    lens = np.array([len(r) for r in reads])
    total = int(lens.sum()) + m
    lcap = _round_up(_pad_pow2(-(-total // D), lo=4096), K)
    flat = np.full(D * lcap, PAD, np.int8)
    bwt_np = flat.reshape(D, lcap)
    strides = ((lens + 8) & ~7).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(strides)[:-1]])
    bufcap = _round_up(_pad_pow2(int(strides.sum()), lo=64), D * 8)
    buf_np = np.zeros(bufcap, np.int8)
    for i, r in enumerate(reads):
        buf_np[starts[i] : starts[i] + len(r)] = r[::-1]
    mpad = _round_up(max(_pad_pow2(m), D), D)
    npad = mpad - m
    pk = np.full(mpad, -1, np.int32)
    pk[npad:] = starts
    l = np.zeros(mpad, np.int32)
    u = np.zeros(mpad, np.int32)  # RLO: u = n_sent = 0 initially

    shard = NamedSharding(mesh, P(("h", "s")))
    rep = NamedSharding(mesh, P())

    def put(arr, sh):
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx]
        )

    blkp_np = np.zeros((D, lcap // K + 1, 6), np.int32)
    state = ShardedBwt(
        bwt=put(bwt_np, shard),
        blk_prefix=put(blkp_np, shard),
        n=put(np.asarray(0, np.int64), rep),
        psize=put(np.zeros(6, np.int64), rep),
        pcounts=put(np.zeros((6, 6), np.int64), rep),
    )
    rs = ReadStates(
        l=put(l, shard), u=put(u, shard), pk=put(pk, shard)
    )
    jbuf = put(buf_np, shard)
    nr = put(np.asarray(int(lens.max()) + 1, np.int64), rep)

    state, _ = sharded_bcr_batch(
        state, rs, jbuf, nr, K=K, so=1, lcap=lcap, mesh=mesh, d=D
    )

    # every process checks its own shards against the expected global BWT
    exp = np.full(D * lcap, PAD, np.int8)
    exp[: want.shape[0]] = want
    exp2 = exp.reshape(D, lcap)
    checked = 0
    for sh_ in state.bwt.addressable_shards:
        got = np.asarray(sh_.data)
        wanted = exp2[sh_.index]
        r0 = sh_.index[0].start or 0
        # rows past the live prefix hold unspecified content on the
        # sharded path only beyond n; compare the live region per row
        for j in range(got.shape[0]):
            gstart = (r0 + j) * lcap
            live = min(max(want.shape[0] - gstart, 0), lcap)
            assert np.array_equal(got[j, :live], wanted[j, :live]), (
                pid, r0 + j)
        checked += 1
    assert checked >= 4, checked
    print(f"MPSIM OK {pid} ({checked} shards checked)", flush=True)


if __name__ == "__main__":
    main()
