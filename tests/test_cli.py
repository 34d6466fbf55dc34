"""End-to-end CLI parity vs the reference binary: same flags, same bytes.

Covers the preprocessing pipeline (-q/-N/-x/-C/-F/-R), input formats
(line/fasta/fastq, gzip), sorting orders, and batching."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_reads, reads_to_lines, run_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, input_bytes):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "ropebwt2_tpu.cli", *args],
        input=input_bytes,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        cwd=REPO,
        env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout


def to_fasta(reads) -> bytes:
    tab = "$ACGTN"
    return "".join(
        f">r{i}\n" + "".join(tab[c] for c in r) + "\n"
        for i, r in enumerate(reads)
    ).encode()


def to_fastq(reads, rng) -> bytes:
    tab = "$ACGTN"
    out = []
    for i, r in enumerate(reads):
        seq = "".join(tab[c] for c in r)
        qual = "".join(
            chr(33 + int(q)) for q in rng.integers(0, 42, size=len(r))
        )
        out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("flags", ["-LR", "-LRs", "-LRr", "-L", "-LF"])
def test_cli_line_mode_parity(flags, ref_binary, rng):
    reads = random_reads(rng, n=30, lo=3, hi=20, with_n=True)
    data = reads_to_lines(reads)
    assert run_cli([flags, "-"], data) == run_ref(ref_binary, [flags, "-"], data)


def test_cli_fasta_parity(ref_binary, rng):
    reads = random_reads(rng, n=20, lo=4, hi=25)
    data = to_fasta(reads)
    assert run_cli(["-R", "-"], data) == run_ref(ref_binary, ["-R", "-"], data)


def test_cli_fasta_gzip(ref_binary, rng):
    reads = random_reads(rng, n=15)
    data = gzip.compress(to_fasta(reads))
    assert run_cli(["-R", "-"], data) == run_ref(ref_binary, ["-R", "-"], data)


def test_cli_fastq_quality_mask(ref_binary, rng):
    reads = random_reads(rng, n=25, lo=5, hi=30)
    data = to_fastq(reads, rng)
    for flags in (["-R", "-q20", "-"], ["-R", "-q20", "-N", "-"]):
        assert run_cli(flags, data) == run_ref(ref_binary, flags, data)


@pytest.mark.parametrize(
    "flags",
    [
        ["-LR", "-x3", "-"],
        ["-LR", "-x1", "-C", "-"],
        ["-L", "-x2", "-"],
        ["-LR", "-N", "-"],
        ["-LR", "-C", "-"],
        ["-L", "-C", "-s", "-"],
    ],
)
def test_cli_preprocessing_parity(flags, ref_binary, rng):
    reads = random_reads(rng, n=30, lo=1, hi=18, with_n=True)
    # add adversarial reads: all-N, palindromes, single bases
    reads += [[5, 5, 5], [1, 4], [2, 3, 2, 3], [1], [1, 2, 3, 5, 3, 2, 1]]
    data = reads_to_lines(reads)
    assert run_cli(flags, data) == run_ref(ref_binary, flags, data)


def test_rlo_shuffle_invariance(rng):
    """The README's identity (README.md:15-25): `shuf | -LRs` equals
    `rev | sort | rev | -LR` — RLO output is input-order invariant and
    equals explicit reverse-lexicographic pre-sorting."""
    reads = random_reads(rng, n=25, lo=3, hi=12)
    data = reads_to_lines(reads)
    out_rlo = run_cli(["-LRs", "-"], data)

    shuffled = list(reads)
    rng.shuffle(shuffled)
    assert run_cli(["-LRs", "-"], reads_to_lines(shuffled)) == out_rlo

    presorted = sorted(reads, key=lambda r: tuple(reversed(r)))
    assert run_cli(["-LR", "-"], reads_to_lines(presorted)) == out_rlo


def test_rclo_recipe_equivalence(rng):
    """`-LRr` == complement-sort recipe (README.md:21-25)."""
    reads = random_reads(rng, n=20, lo=3, hi=10)
    out_rclo = run_cli(["-LRr", "-"], reads_to_lines(reads))
    comp = lambda c: 5 - c if 1 <= c <= 4 else c  # noqa: E731
    presorted = sorted(reads, key=lambda r: tuple(comp(c) for c in reversed(r)))
    assert run_cli(["-LR", "-"], reads_to_lines(presorted)) == out_rclo


def test_cli_small_batches_match(ref_binary, rng):
    """-m batching: many small flushes == reference with one batch."""
    reads = random_reads(rng, n=40, lo=3, hi=12)
    data = reads_to_lines(reads)
    got = run_cli(["-LR", "-m100", "-"], data)
    want = run_ref(ref_binary, ["-LR", "-"], data)
    assert got == want


def test_cli_python_fallback_paths(ref_binary, rng):
    """ROPEBWT2_TPU_NATIVE=0 forces the pure-Python reader/writers; output
    must be unchanged."""
    reads = random_reads(rng, n=20, lo=3, hi=15, with_n=True)
    data = reads_to_lines(reads)
    old = os.environ.get("ROPEBWT2_TPU_NATIVE")
    os.environ["ROPEBWT2_TPU_NATIVE"] = "0"
    try:
        for flags in (["-LRs", "-"], ["-LRd", "-"], ["-LRB", "-"]):
            assert run_cli(flags, data) == run_ref(ref_binary, flags, data)
    finally:
        if old is None:
            os.environ.pop("ROPEBWT2_TPU_NATIVE", None)
        else:
            os.environ["ROPEBWT2_TPU_NATIVE"] = old


def test_cli_single_string_mode(ref_binary, rng):
    """-m0 single-string insertion path."""
    reads = random_reads(rng, n=6, lo=3, hi=10)
    data = reads_to_lines(reads)
    assert run_cli(["-LR", "-m0", "-"], data) == run_ref(
        ref_binary, ["-LR", "-m0", "-"], data
    )


def test_cli_output_file(ref_binary, rng, tmp_path):
    reads = random_reads(rng, n=10)
    data = reads_to_lines(reads)
    out = tmp_path / "out.bwt"
    run_cli(["-LR", "-o", str(out), "-"], data)
    assert out.read_bytes() == run_ref(ref_binary, ["-LR", "-"], data)


@pytest.mark.parametrize("native", ["1", "0"])
def test_kseq_stream_boundary_phantom_line(native, ref_binary):
    """kstream quirk (kseq.h:91-141): a line-mode stream whose decompressed
    length is an exact multiple of the 16384-byte kseq buffer (incl. the
    empty stream) yields ONE phantom empty read — the reference inserts an
    extra lone sentinel.  Both our readers emulate it; off-by-one sizes
    must NOT produce it."""
    rng = np.random.default_rng(3)
    reads = rng.integers(1, 5, size=(160, 101)).astype(np.int8)
    lut = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    data = bytearray()
    for r in lut[reads]:
        data += bytes(r) + b"\n"
    pad = 16384 - len(data) - 1
    data += b"A" * pad + b"\n"
    assert len(data) == 16384
    for payload in (bytes(data), bytes(data[:-103] + b"G\n"), b""):
        os.environ["ROPEBWT2_TPU_NATIVE"] = native
        try:
            out = run_cli(["-LRs", "-"], payload)
        finally:
            os.environ.pop("ROPEBWT2_TPU_NATIVE", None)
        assert out == run_ref(ref_binary, ["-LRs", "-"], payload), (
            len(payload)
        )
