"""Device-mesh sharding for the BCR engine.

The reference's only thread-level parallelism is the 5-way symbol-bucket
pthread split (mrope.c:235-256).  On a device mesh the natural axes are
instead:

* the flat BWT buffer (and its rank tables) sharded by position range —
  the 'index parallel' axis; rank gathers and the merge pass become
  collective traffic between devices
* the per-read state arrays sharded by read — the data-parallel axis

The sharded engine (parallel/sharded.py) runs an explicit ``shard_map``
pipeline with all-to-all query routing over these meshes.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis="shard"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh2d(hosts, shards, host_axis="h", shard_axis="s"):
    """2-D (host, shard) mesh for multi-host scale-out (SURVEY.md §7.7).

    Host-major device order: shard ranges [h*S*LCAP ...] are contiguous
    within a host, so the neighbor-heavy collectives (sort re-shard, the
    merge tail ppermute) stay inside a host and only host-boundary rows
    cross the network.  Under ``jax.distributed`` each process contributes
    its local devices to the same global mesh, host-major.  On one host,
    where every device reaches every other at the same rate, the 2-D mesh
    is only a multi-host scaffold.  The sharded engine consumes the mesh
    through the flattened axis tuple (parallel/sharded.py)."""
    devs = jax.devices()
    n = hosts * shards
    assert len(devs) >= n, (len(devs), n)
    return Mesh(
        np.array(devs[:n]).reshape(hosts, shards),
        (host_axis, shard_axis),
    )


def shard_state(state, mesh, axis="shard"):
    """Shard the flat BWT buffer by position range; small tables are
    replicated (they are O(N/K) and participate in every shard's ranks)."""
    import dataclasses

    s_bwt = NamedSharding(mesh, P(axis))
    s_rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        state,
        bwt=jax.device_put(state.bwt, s_bwt),
        n=jax.device_put(state.n, s_rep),
        psize=jax.device_put(state.psize, s_rep),
        pcounts=jax.device_put(state.pcounts, s_rep),
        blk_prefix=jax.device_put(state.blk_prefix, s_rep),
    )


def shard_reads(reads, mesh, axis="shard"):
    import dataclasses

    s_dp = NamedSharding(mesh, P(axis))
    return dataclasses.replace(
        reads,
        l=jax.device_put(reads.l, s_dp),
        u=jax.device_put(reads.u, s_dp),
        pk=jax.device_put(reads.pk, s_dp),
    )
