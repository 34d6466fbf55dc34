"""End-to-end engine parity in 4-bit packed capacity mode (forced via the
ROPEBWT2_TPU_PACK4 threshold): the packed engine must be byte-identical to
the int8 engine (itself reference-verified) for every sorting order,
across incremental batches, deferred merging, and the query surface."""

import numpy as np
import pytest

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.oracle import SO_IO, SO_RCLO, SO_RLO

from conftest import random_reads


@pytest.fixture
def force_packed(monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "1")


@pytest.mark.parametrize("so", [SO_IO, SO_RLO, SO_RCLO])
def test_packed_engine_parity(so, rng, force_packed):
    from ropebwt2_tpu.index.packed import PackedFlatBwt

    reads = random_reads(rng, n=64, lo=4, hi=30, with_n=True)
    plain = TpuBwt(so=so)
    packed = TpuBwt(so=so)
    import os
    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    plain.insert_multi(reads[:30])
    plain.insert_multi(reads[30:])
    os.environ["ROPEBWT2_TPU_PACK4"] = "1"
    packed.insert_multi(reads[:30])
    packed.insert_multi(reads[30:])
    assert isinstance(packed.state, PackedFlatBwt)
    assert np.array_equal(packed.bwt_array(), plain.bwt_array())
    assert np.array_equal(packed.counts(), plain.counts())


def test_packed_engine_deferred(rng, force_packed):
    plain = TpuBwt(so=SO_RLO, defer_r=0)
    packed = TpuBwt(so=SO_RLO, defer_r=4)
    reads = random_reads(rng, n=80, lo=6, hi=40)
    import os
    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    plain.insert_multi(reads)
    os.environ["ROPEBWT2_TPU_PACK4"] = "1"
    packed.insert_multi(reads)
    assert np.array_equal(packed.bwt_array(), plain.bwt_array())


def test_packed_convert_midway(rng):
    """int8 -> packed conversion between batches (threshold crossing) must
    preserve the index exactly."""
    import os
    reads = random_reads(rng, n=60, lo=5, hi=25)
    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    plain = TpuBwt(so=SO_RLO)
    plain.insert_multi(reads)

    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    conv = TpuBwt(so=SO_RLO)
    conv.insert_multi(reads[:20])
    os.environ["ROPEBWT2_TPU_PACK4"] = "1"  # threshold crossed "now"
    conv.insert_multi(reads[20:])
    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    from ropebwt2_tpu.index.packed import PackedFlatBwt
    assert isinstance(conv.state, PackedFlatBwt)
    assert np.array_equal(conv.bwt_array(), plain.bwt_array())


def test_packed_queries(rng, force_packed):
    from ropebwt2_tpu.engine.query import backward_search, rank1a
    import jax.numpy as jnp
    import os

    reads = random_reads(rng, n=50, lo=8, hi=30)
    os.environ["ROPEBWT2_TPU_PACK4"] = "1"
    eng = TpuBwt(so=SO_RLO)
    eng.insert_multi(reads)
    os.environ["ROPEBWT2_TPU_PACK4"] = "0"
    ref = TpuBwt(so=SO_RLO)
    ref.insert_multi(reads)
    pos = np.sort(rng.integers(0, eng.n + 1, 200)).astype(np.int64)
    a = np.asarray(rank1a(eng.state, jnp.asarray(pos)))
    b = np.asarray(rank1a(ref.state, jnp.asarray(pos)))
    assert np.array_equal(a, b)
    pat = np.asarray(reads[0][-8:], np.int32)[None, :]
    lo1, hi1 = backward_search(eng.state, jnp.asarray(pat),
                               jnp.asarray([8], np.int32))
    lo2, hi2 = backward_search(ref.state, jnp.asarray(pat),
                               jnp.asarray([8], np.int32))
    assert int(hi1[0] - lo1[0]) == int(hi2[0] - lo2[0]) >= 1


def test_packed_export_formats(rng, force_packed, tmp_path, ref_binary):
    """Exports (text/FMR) from a packed-mode index must be byte-identical
    to the reference binary's output on the same reads."""
    import os
    import subprocess
    import sys

    from conftest import random_reads, reads_to_lines, run_ref

    reads = random_reads(rng, n=40, lo=5, hi=25)
    data = reads_to_lines(reads)
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu",
               ROPEBWT2_TPU_PACK4="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for flags in (["-LRs"], ["-LRsb"]):
        r = subprocess.run(
            [sys.executable, "-m", "ropebwt2_tpu.cli"] + flags + ["-"],
            input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=repo, env=env,
        )
        assert r.returncode == 0, r.stderr.decode()
        want = run_ref(ref_binary, flags + ["-"], data)
        assert r.stdout == want, flags
