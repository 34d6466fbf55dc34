"""Weak-scaling shape check of the sharded BCR engine on the virtual CPU
mesh: fixed per-shard work (M/D reads, LCAP/D buffer), D = 1, 2, 4, 8.

CPU-mesh wall times are NOT a device performance claim (XLA:CPU serializes
the shards on one host and its collective implementations differ) — this run
validates that per-shard arrays, collective shapes, and round counts stay
constant as D grows, and provides the parity check at each D.  The
collective-volume model lives in HACKING.md.

Env: WEAK_M0 (reads per shard, default 2048), WEAK_L (default 64).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    )

import numpy as np  # noqa: E402


def main():
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from jax.sharding import Mesh  # noqa: E402

    from ropebwt2_tpu.engine import TpuBwt  # noqa: E402
    from ropebwt2_tpu.parallel.sharded import AXIS, ShardedTpuBwt  # noqa: E402

    m0 = int(os.environ.get("WEAK_M0", 2048))
    L = int(os.environ.get("WEAK_L", 64))
    devs = jax.devices()
    rng = np.random.default_rng(3)

    print(f"WEAK per-shard reads={m0} L={L} (weak scaling: total = D*m0)")
    for d in (1, 2, 4, 8):
        reads = rng.integers(1, 5, size=(d * m0, L)).astype(np.int8)
        mesh = Mesh(np.asarray(devs[:d]), (AXIS,))
        eng = ShardedTpuBwt(so=1, K=256, mesh=mesh)
        t0 = time.time()
        eng.insert_multi(list(reads))
        got = eng.bwt_array()
        wall = time.time() - t0
        ref = TpuBwt(so=1, K=256)
        ref.insert_multi(reads)
        ok = np.array_equal(got, ref.bwt_array())
        syms = d * m0 * (L + 1)
        print(
            f"WEAK D={d}: {syms} syms in {wall:.2f}s (compile incl.) "
            f"parity={'ok' if ok else 'FAIL'}"
        )
        assert ok


if __name__ == "__main__":
    main()
