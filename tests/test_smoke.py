"""chip_smoke.py's contract and the pieces it trusts: it refuses to run
without a GPU, the golden md5 table is self-consistent, the CLI fixtures
match this repo's writers, the host rank reference is exact, and the
compile cache lands where it should."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(args, env=None, cwd=REPO, timeout=300):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _has_result(stdout):
    return '"ok"' in stdout


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run(["chip_smoke.py"], env=env)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not _has_result(r.stdout)


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo beside it the script fails and prints
    no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = _run(["chip_smoke.py"], env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert not _has_result(r.stdout)


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    probe = _run(["-c", "import jax; print(jax.devices()[0].platform)"],
                 env=env)
    if probe.returncode != 0 or probe.stdout.strip() != "gpu":
        pytest.skip("no GPU: JAX finds only " + probe.stdout.strip())
    r = _run(["chip_smoke.py"], env=env, timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = _run(["-c", "import ropebwt2_tpu, jax; "
                    "print(jax.config.jax_compilation_cache_dir)"], env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


def test_golden_table_consistent():
    g = json.load(open(chip_smoke.GOLDEN))
    for name, e in g["builds"].items():
        if e["kind"] == "readgen":
            assert e["symbols"] == e["nreads"] * (e["L"] + 1), name
        else:
            lens = np.random.default_rng(e["seed"]).integers(
                e["len_min"], e["len_max"] + 1, e["nreads"])
            assert e["symbols"] == int(lens.sum()) + e["nreads"], name
        # kseq's phantom empty read appears exactly when the text length
        # (= symbols: one newline per read) fills whole 16 KiB buffers
        assert e["phantom_empty_read"] == (e["symbols"] % 16384 == 0), name
        assert e["tier"] in ("flat", "packed", "runs"), name
        assert len(e["md5"]) == 32 and int(e["md5"], 16) >= 0, name
    assert set(g["cli"]["md5"]) == set(chip_smoke.CLI_FORMATS)
    assert g["builds"]["scale_r05"]["md5"] == (
        "ef93d30ba38c0b39c3809ce3ed5a1a23")


def test_cli_fixtures_match_writers(tmp_path):
    """The CLI phase, run here on the CPU, reproduces its fixtures."""
    want = json.load(open(chip_smoke.GOLDEN))["cli"]["md5"]
    assert chip_smoke.cli_md5s(str(tmp_path)) == want


def test_host_rank_matches_direct_counts():
    rng = np.random.default_rng(0)
    bwt = rng.integers(0, 6, 300_000).astype(np.int8)
    hr = chip_smoke.HostRank(bwt)
    for p in (0, 1, 65535, 65536, 65537, 123457, 300_000):
        want = np.bincount(bwt[:p], minlength=6)
        assert np.array_equal(hr(p), want), p


def test_query_phase_on_cpu():
    """The queries phase over a small coverage index built here: device
    rank, extend and backward_search equal the host counts."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import readgen
    from ropebwt2_tpu.engine import TpuBwt

    gen = readgen.ReadGen(seed=5, nreads=2048, L=40, mode="coverage",
                          cov=10.0, err=0.01)
    eng = TpuBwt(so=1)
    eng.insert_multi(gen.batch(2048).view(np.int8))
    chip_smoke.phase_queries(eng, eng.bwt_array(), gen)
