"""Test config: run JAX on a virtual 8-device CPU mesh.

Testing multi-device logic without a cluster (SURVEY.md §4): XLA_FLAGS
forces 8 host devices so sharding/collective code paths compile and run
under pytest on any machine.  Must be set before jax is imported.  Tests
that need the GPU carry the ``gpu`` marker and decide inside the test.
"""

import os
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

assert jax.default_backend() == "cpu", jax.devices()
assert len(jax.devices()) >= 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF_SRC = "/root/reference"
REF_BIN = "/tmp/ropebwt2_ref/ropebwt2"


@pytest.fixture(scope="session")
def ref_binary():
    """Compile the reference C program (out of tree) to use as a parity
    oracle.  Tests that need it are skipped if the toolchain is missing."""
    if os.path.exists(REF_BIN):
        return REF_BIN
    os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
    srcs = [
        os.path.join(REF_SRC, f)
        for f in ("main.c", "mrope.c", "rope.c", "rle.c", "rld0.c", "crlf.c")
    ]
    cmd = ["gcc", "-O2", "-o", REF_BIN, *srcs, "-lz", "-lpthread", "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, cwd=REF_SRC)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"cannot build reference binary: {e}")
    return REF_BIN


def run_ref(ref_bin, args, input_bytes):
    """Run the reference binary on stdin bytes, return stdout bytes."""
    r = subprocess.run(
        [ref_bin, *args], input=input_bytes, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, check=True,
    )
    return r.stdout


def random_reads(rng, n, lo=3, hi=12, alpha=4, with_n=False):
    """Random nt6 read lists (original orientation, codes 1..4 [+5])."""
    hi_code = 5 if with_n else 4
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        out.append(list(rng.integers(1, hi_code + 1, size=ln).astype(int)))
    return out


def reads_to_lines(reads) -> bytes:
    """nt6 reads -> one-sequence-per-line ASCII for `ropebwt2 -L`."""
    tab = "$ACGTN"
    return "".join("".join(tab[c] for c in r) + "\n" for r in reads).encode()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
