"""Randomized end-to-end parity fuzzing: random flag combinations, input
formats, and read mixes vs the reference binary."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import random_reads, run_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAB = "$ACGTN"


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


def _mk_input(rng, reads, kind):
    if kind == "line":
        data = "".join(
            "".join(TAB[c] for c in r) + "\n" for r in reads
        ).encode()
        return data, ["-L"]
    if kind == "fasta":
        data = "".join(
            f">r{i}\n" + "".join(TAB[c] for c in r) + "\n"
            for i, r in enumerate(reads)
        ).encode()
        return data, []
    if kind == "fastq":
        out = []
        for i, r in enumerate(reads):
            seq = "".join(TAB[c] for c in r)
            qual = "".join(
                chr(33 + int(q)) for q in rng.integers(0, 42, size=len(r))
            )
            out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
        return "".join(out).encode(), []
    raise ValueError(kind)


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_flag_combinations(seed, ref_binary):
    rng = np.random.default_rng(1000 + seed)
    reads = random_reads(
        rng, n=int(rng.integers(5, 30)), lo=1, hi=25, with_n=True
    )
    # sprinkle adversarial shapes
    reads += [[5] * int(rng.integers(1, 4)), [1], [2, 3, 3, 2]]
    kind = ["line", "fasta", "fastq"][int(rng.integers(0, 3))]
    data, flags = _mk_input(rng, reads, kind)
    if rng.random() < 0.3:
        data = gzip.compress(data)

    if rng.random() < 0.5:
        flags.append(["-s", "-r"][int(rng.integers(0, 2))])
    if rng.random() < 0.4:
        flags.append(["-F", "-R"][int(rng.integers(0, 2))])
    if rng.random() < 0.3:
        flags.append("-N")
    if rng.random() < 0.3:
        flags.append(f"-x{int(rng.integers(0, 5))}")
    if rng.random() < 0.3:
        flags.append("-C")
    if kind == "fastq" and rng.random() < 0.5:
        flags.append(f"-q{int(rng.integers(1, 35))}")
    if rng.random() < 0.3:
        flags.append(f"-m{int(rng.integers(50, 500))}")
    out_mode = rng.random()
    if out_mode < 0.2:
        flags.append("-d")
    elif out_mode < 0.4:
        flags.append("-B")

    args = [*flags, "-"]
    got = run_cli(args, data)
    want = run_ref(ref_binary, args, data)
    assert got == want, f"flags={args} kind={kind}"
