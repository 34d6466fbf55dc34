"""Long-read construction (the reference's headline differentiator,
tex/ropebwt2.tex:263-267) and CLI checkpoint/resume."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.oracle import SO_RLO

from conftest import random_reads, reads_to_lines, run_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, input_bytes):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", *args],
        input=input_bytes, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout


def test_long_reads_mixed_lengths(ref_binary, rng):
    """kb-scale reads mixed with short ones — long sequential backward-search
    chains, ragged batch."""
    reads = [list(rng.integers(1, 5, size=int(n))) for n in (1500, 3, 800, 2500, 40, 1)]
    data = reads_to_lines(reads)
    got = run_cli(["-LRs", "-"], data)
    want = run_ref(ref_binary, ["-LRs", "-"], data)
    assert got == want


def test_long_reads_library(ref_binary, rng):
    reads = [list(rng.integers(1, 5, size=int(rng.integers(200, 1200)))) for _ in range(12)]
    eng = TpuBwt(so=SO_RLO)
    eng.insert_multi(reads)
    from ropebwt2_tpu.io.text import bwt_to_text

    want = run_ref(ref_binary, ["-LRs", "-"], reads_to_lines(reads))
    assert bwt_to_text(eng.bwt_array()) == want


def test_cli_checkpoint_resume(ref_binary, rng, tmp_path):
    """-b dump + -i resume through the CLI == one-shot construction (the
    reference's checkpoint/resume workflow, README.md:70-73), including a
    'failure' between the two runs (separate processes)."""
    reads = random_reads(rng, n=30, lo=5, hi=18)
    a, b = reads[:15], reads[15:]
    fmr = tmp_path / "ckpt.fmr"
    out = run_cli(["-LRs", "-b", "-o", str(fmr), "-"], reads_to_lines(a))
    assert out == b""
    got = run_cli(["-LR", "-i", str(fmr), "-"], reads_to_lines(b))
    want = run_ref(ref_binary, ["-LRs", "-"], reads_to_lines(reads))
    assert got == want


def test_cli_binary_outputs_parity(ref_binary, rng):
    """-d and -B CLI outputs byte-identical to the reference CLI."""
    reads = random_reads(rng, n=25, lo=4, hi=20, with_n=True)
    data = reads_to_lines(reads)
    for flags in (["-LRd", "-"], ["-LRB", "-"], ["-LRsd", "-"]):
        assert run_cli(flags, data) == run_ref(ref_binary, flags, data)


def test_cli_tree_dump_runs(rng):
    """-T produces a parenthesized dump whose content concatenation is the
    BWT (shape is our packing, content identical)."""
    reads = random_reads(rng, n=8)
    out = run_cli(["-LRT", "-"], reads_to_lines(reads))
    t = out.decode()
    assert t.count("(") == t.count(")") and t.count("(") >= 6
    inner = "".join(ch for ch in t if ch in "$ACGTN")
    got = run_cli(["-LR", "-"], reads_to_lines(reads)).decode().strip()
    assert inner == got


def test_multi_kbp_reads_parity(rng, ref_binary):
    """Config #4 regime (tex/ropebwt2.tex:263-267, Moleculo README.md:186):
    multi-kbp reads, tiny active set over a growing prefix — the worst case
    of flat-rebuild economics and the motivating case for the deferred
    pending index.  Parity vs the reference binary with deferral forced."""
    reads = [
        rng.integers(1, 5, size=int(ln)).astype(np.int8)
        for ln in rng.integers(2000, 5001, size=8)
    ]
    lines = reads_to_lines(reads)
    want = run_ref(ref_binary, ["-LRs", "-"], lines)
    eng = TpuBwt(so=SO_RLO, defer_r=16)
    eng.insert_multi(reads)
    lut = np.frombuffer(b"$ACGTN", np.uint8)
    got = lut[eng.bwt_array()].tobytes() + b"\n"
    assert got == want


def test_round_chunked_dispatch_parity(rng, monkeypatch):
    """Round-range chunking (long-read dispatch splitting) must be
    byte-identical to the single-dispatch path, with and without
    deferral, including chunk boundaries that don't divide the round
    count."""
    import numpy as np
    from ropebwt2_tpu.engine import TpuBwt

    reads = [rng.integers(1, 5, size=int(ln)).astype(np.int8)
             for ln in rng.integers(150, 300, size=24)]
    monkeypatch.setenv("ROPEBWT2_TPU_ROUND_CHUNK", "0")
    ref = TpuBwt(so=1, defer_r=0)
    ref.insert_multi(reads)
    monkeypatch.setenv("ROPEBWT2_TPU_ROUND_CHUNK", "64")
    for dr in (0, 8):
        eng = TpuBwt(so=1, defer_r=dr)
        eng.insert_multi(reads)
        assert np.array_equal(eng.bwt_array(), ref.bwt_array()), dr
        assert np.array_equal(eng.counts(), ref.counts()), dr
