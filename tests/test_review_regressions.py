"""Regression tests for code-review findings (round 1)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import random_reads, reads_to_lines, run_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, input_bytes, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", *args],
        input=input_bytes, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=REPO, env=env,
    )


def test_merge_tail_block_no_insertions(rng):
    """Last output block when every insertion lands far below it (review
    finding 1): the plain merge shifts it by exactly one."""
    from ropebwt2_tpu.index.merge import apply_insertions

    CAP, M = 131072, 16
    n = 128000
    bwt = np.full(CAP, 6, np.int8)
    bwt[:n] = rng.integers(0, 6, n)
    pos = np.zeros(M, np.int64)
    pos[0] = 90000
    sym = np.zeros(M, np.int32)
    sym[0] = 3
    stream = np.zeros(M, np.int64)
    valid = np.zeros(M, bool)
    valid[0] = True
    jargs = [jnp.asarray(x) for x in (pos, sym, stream, valid)]
    got = apply_insertions(jnp.asarray(bwt), jnp.asarray(n), *jargs)
    want = np.insert(bwt[:n], 90000, np.int8(3))
    assert np.array_equal(np.asarray(got)[: n + 1], want)


@pytest.mark.parametrize("native", ["1", "0"])
def test_cut_trim_empty_segments_parity(native, ref_binary):
    """-x0 -C with adjacent/leading/trailing Ns: empty segments vanish in
    the reference (review finding 3)."""
    data = b"ANNA\nNAN\nNNAA\nATNN\nN\n"
    for flags in (["-L", "-x0", "-C", "-R", "-"], ["-L", "-x1", "-C", "-"]):
        r = run_cli(flags, data, {"ROPEBWT2_TPU_NATIVE": native})
        assert r.returncode == 0, r.stderr.decode()
        assert r.stdout == run_ref(ref_binary, flags, data)


@pytest.mark.parametrize("native", ["1", "0"])
def test_truncated_fastq_no_crash(native, ref_binary):
    """Truncated quality (review findings 5/7): no crash, same output as
    the reference (kseq stops with -2)."""
    data = b"@r1\nACGTACGT\n+\nIIII"
    r = run_cli(["-R", "-"], data, {"ROPEBWT2_TPU_NATIVE": native})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == run_ref(ref_binary, ["-R", "-"], data)


@pytest.mark.parametrize("native", ["1", "0"])
def test_empty_seq_fastq_record(native, ref_binary):
    """Empty-sequence FASTQ record consumes one quality line and stops
    parsing like kseq (review finding 7)."""
    data = b"@r1\n\n+\n@\n@r2\nACGT\n+\nIIII\n"
    r = run_cli(["-R", "-"], data, {"ROPEBWT2_TPU_NATIVE": native})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == run_ref(ref_binary, ["-R", "-"], data)


@pytest.mark.parametrize("native", ["1", "0"])
def test_fmr_param_clamps(native, ref_binary, rng):
    """-l16 -n5 FMR bytes carry the reference's clamped params (review
    finding 6)."""
    reads = random_reads(rng, n=10, lo=4, hi=12)
    data = reads_to_lines(reads)
    flags = ["-LRb", "-l16", "-n5", "-"]
    r = run_cli(flags, data, {"ROPEBWT2_TPU_NATIVE": native})
    assert r.returncode == 0, r.stderr.decode()
    ours = r.stdout
    theirs = run_ref(ref_binary, flags, data)
    # header: magic+so then per-rope max_nodes/block_len — must match
    assert ours[:12] == theirs[:12]
    # and the reference must restore our dump
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".fmr", delete=False) as f:
        f.write(ours)
        path = f.name
    more = reads_to_lines(random_reads(rng, n=5))
    out = run_ref(ref_binary, ["-LR", "-i", path, "-"], more)
    assert out  # restored + extended without crashing
    os.unlink(path)


def test_native_oversized_record_carry(rng, tmp_path):
    """A record larger than the batch buffer is retried, not dropped
    (review finding 2)."""
    nlib = pytest.importorskip("ropebwt2_tpu.native.lib")
    if not nlib.native_available():
        pytest.skip("no native toolchain")
    seq = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 500))
    p = tmp_path / "big.txt"
    p.write_text(seq + "\nAC\n")
    r = nlib.NativeReader(str(p), line_mode=True)
    batches = []
    while True:
        b = r.next_batch(min_fill=8, slack=64)  # far smaller than the record
        if b is None:
            break
        batches.append(b)
    r.close()
    total = np.concatenate(batches)
    # both strands of both records, NUL-terminated: 2*(500+1) + 2*(2+1)
    assert len(total) == 2 * 501 + 2 * 3
    assert int((total == 0).sum()) == 4


def test_cli_corrupt_fmr_clean_error(tmp_path):
    """Corrupt -i file: clean [E::] error, exit 1, no traceback (review
    finding 8)."""
    bad = tmp_path / "bad.fmr"
    bad.write_bytes(b"RB\x02\x00garbage")
    r = run_cli(["-LR", "-i", str(bad), "-"], b"ACGT\n")
    assert r.returncode == 1
    err = r.stderr.decode()
    assert "[E::main]" in err and "Traceback" not in err
    bad.write_bytes(b"NOPE")
    r = run_cli(["-LR", "-i", str(bad), "-"], b"ACGT\n")
    assert r.returncode == 1 and "Traceback" not in r.stderr.decode()


def test_cumsum_blocked_exact_large_values():
    """exact=True keeps huge per-element counts exact (review finding 4)."""
    from ropebwt2_tpu.index.scan import cumsum_blocked

    x = np.zeros(4096, np.int32)
    x[7] = (1 << 24) + 3  # beyond f32 integer exactness
    x[100] = 5
    x[4000] = (1 << 24) + 1
    got = np.asarray(cumsum_blocked(jnp.asarray(x), exact=True))
    assert np.array_equal(got, np.cumsum(x))


def test_query_K_derived_from_state(rng):
    """rank functions derive K from the state (review finding 9)."""
    from ropebwt2_tpu.engine import TpuBwt
    from ropebwt2_tpu.engine.query import rank1a

    reads = random_reads(rng, n=10)
    eng = TpuBwt(so=0, K=512)
    eng.insert_multi(reads)
    bwt = eng.bwt_array()
    pos = np.asarray([0, len(bwt) // 2, len(bwt)], dtype=np.int64)
    occ = np.asarray(rank1a(eng.state, jnp.asarray(pos)))  # no K passed
    for i, p in enumerate(pos):
        for s in range(6):
            assert occ[i, s] == int((bwt[:p] == s).sum())


def test_mxu_safe_fallback_paths(monkeypatch):
    """A default-precision f32 dot may round its operands (bf16 or TF32,
    so integers above 2^8 or 2^11 round) — all contractions pin
    precision=HIGHEST (index/scan.py), and the Wc/We contraction falls back
    to a static-mask integer path beyond its f32 value bound.  Force that
    bound to 1 so the fallback runs at test size and must reproduce the
    default path's BWT exactly."""
    import numpy as np

    import ropebwt2_tpu.engine.bcr as bcr
    from ropebwt2_tpu.engine import TpuBwt

    rng = np.random.default_rng(11)
    mat = rng.integers(1, 5, size=(300, 23)).astype(np.int8)
    ragged = [rng.integers(1, 5, size=rng.integers(3, 40)).astype(np.int8)
              for _ in range(64)]
    want = {}
    for so in (0, 1, 2):
        eng = TpuBwt(so=so)
        eng.insert_multi(mat)
        eng.insert_multi(ragged)
        want[so] = eng.bwt_array()

    import jax

    monkeypatch.setattr(bcr, "_EM_EINSUM_MAX", 1)
    jax.clear_caches()  # thresholds are trace-time: force re-trace
    try:
        for so in (0, 1, 2):
            eng = TpuBwt(so=so)
            eng.insert_multi(mat)
            eng.insert_multi(ragged)
            assert np.array_equal(eng.bwt_array(), want[so]), so
    finally:
        jax.clear_caches()  # don't leak patched traces to other tests
