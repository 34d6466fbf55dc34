"""End-to-end engine parity in run-length compressed mode (forced via
ROPEBWT2_TPU_RUNS): the run-tier engine must be byte-identical to the
int8 engine (itself reference-verified) for every sorting order, across
incremental batches, deferred merging, mid-build conversion, growth, and
the query surface."""

import os

import numpy as np
import pytest

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.oracle import SO_IO, SO_RCLO, SO_RLO

from conftest import random_reads


@pytest.fixture
def runs_env(monkeypatch):
    monkeypatch.setenv("ROPEBWT2_TPU_RUNS", "1")
    monkeypatch.setenv("ROPEBWT2_TPU_PACK4", "0")
    return monkeypatch


def _build(mp, reads, so, runs, splits=1, defer_r=None):
    mp.setenv("ROPEBWT2_TPU_RUNS", "1" if runs else "0")
    eng = TpuBwt(so=so, defer_r=defer_r)
    step = max(len(reads) // splits, 1)
    for lo in range(0, len(reads), step):
        eng.insert_multi(reads[lo : lo + step])
    mp.setenv("ROPEBWT2_TPU_RUNS", "0")
    return eng


@pytest.mark.parametrize("so", [SO_IO, SO_RLO, SO_RCLO])
def test_runs_engine_parity(so, rng, runs_env):
    from ropebwt2_tpu.index.runs import RunBwt

    reads = random_reads(rng, n=64, lo=4, hi=30, with_n=True)
    plain = _build(runs_env, reads, so, runs=False, splits=2)
    re = _build(runs_env, reads, so, runs=True, splits=2)
    assert isinstance(re.state, RunBwt)
    assert np.array_equal(re.bwt_array(), plain.bwt_array())
    assert np.array_equal(re.counts(), plain.counts())


def test_runs_engine_deferred(rng, runs_env):
    reads = random_reads(rng, n=80, lo=6, hi=40)
    plain = _build(runs_env, reads, SO_RLO, runs=False, defer_r=0)
    re = _build(runs_env, reads, SO_RLO, runs=True, defer_r=4)
    assert np.array_equal(re.bwt_array(), plain.bwt_array())


def test_runs_compressibility(rng, runs_env):
    """Duplicated reads (coverage proxy) must keep the run count well
    below n — the tier's entire point."""
    base = random_reads(rng, n=12, lo=20, hi=30)
    reads = [base[i % len(base)] for i in range(120)]
    re = _build(runs_env, reads, SO_RLO, runs=True)
    assert int(re.state.nslot) < re.n // 3
    assert int(re.state.overflow) == 0


def test_runs_convert_midway(rng, monkeypatch):
    reads = random_reads(rng, n=60, lo=5, hi=25)
    monkeypatch.setenv("ROPEBWT2_TPU_RUNS", "0")
    plain = TpuBwt(so=SO_RLO)
    plain.insert_multi(reads)

    conv = TpuBwt(so=SO_RLO)
    conv.insert_multi(reads[:20])
    monkeypatch.setenv("ROPEBWT2_TPU_RUNS", "1")  # threshold crossed "now"
    conv.insert_multi(reads[20:])
    from ropebwt2_tpu.index.runs import RunBwt

    assert isinstance(conv.state, RunBwt)
    assert np.array_equal(conv.bwt_array(), plain.bwt_array())


def test_runs_growth(rng, runs_env):
    """Many small batches force rcap growth (and exercise the slot-bound
    tightening pull)."""
    reads = random_reads(rng, n=120, lo=4, hi=16)
    plain = _build(runs_env, reads, SO_RLO, runs=False)
    re = _build(runs_env, reads, SO_RLO, runs=True, splits=8)
    assert np.array_equal(re.bwt_array(), plain.bwt_array())


def test_runs_queries(rng, runs_env):
    import jax.numpy as jnp

    from ropebwt2_tpu.engine.query import backward_search, rank1a

    reads = random_reads(rng, n=50, lo=8, hi=30)
    eng = _build(runs_env, reads, SO_RLO, runs=True)
    ref = _build(runs_env, reads, SO_RLO, runs=False)
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


def test_runs_cli_text_parity(rng, runs_env, ref_binary):
    """CLI text export from a run-tier index must match the reference
    binary byte-for-byte."""
    import subprocess
    import sys

    from conftest import reads_to_lines, run_ref

    reads = random_reads(rng, n=40, lo=5, hi=25)
    data = reads_to_lines(reads)
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", ROPEBWT2_TPU_RUNS="1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", "-LRs", "-"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=repo, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    want = run_ref(ref_binary, ["-LRs", "-"], data)
    assert r.stdout == want
