"""Native (C++) host runtime vs the pure-Python implementations and the
reference binary: reader/preprocessor batches, format writers."""

import io
import os

import numpy as np
import pytest

from ropebwt2_tpu.engine import TpuBwt
from ropebwt2_tpu.io.crlf import write_crlf
from ropebwt2_tpu.io.fmd import write_fmd
from ropebwt2_tpu.io.fmr import write_fmr
from ropebwt2_tpu.io.preprocess import preprocess_record
from ropebwt2_tpu.io.seqio import open_seq_stream, read_records
from ropebwt2_tpu.io.text import bwt_to_text

from conftest import random_reads, reads_to_lines

nlib = pytest.importorskip("ropebwt2_tpu.native.lib")
if not nlib.native_available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def python_batch(data: bytes, line_mode, tmp_path, **flags):
    """The Python pipeline's NUL-terminated batch buffer for a whole file."""
    p = tmp_path / "in.txt"
    p.write_bytes(data)
    out = []
    with open(p, "rb") as f:
        for seq, qual in read_records(f, line_mode=line_mode):
            for s in preprocess_record(seq, qual, **flags):
                out.append(s.astype(np.uint8))
                out.append(np.zeros(1, np.uint8))
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def native_batch(data: bytes, line_mode, tmp_path, **flags):
    p = tmp_path / "in2.txt"
    p.write_bytes(data)
    r = nlib.NativeReader(str(p), line_mode=line_mode)
    chunks = []
    while True:
        b = r.next_batch(min_fill=1 << 20, slack=1 << 20, **flags)
        if b is None:
            break
        chunks.append(b)
    r.close()
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)


def _flagmap(min_q=0, skip_n=False, cut_n=False, min_cut_len=0,
             trim_pal=False, fwd=True, rev=True):
    return dict(
        py=dict(min_q=min_q, skip_n=skip_n, cut_n=cut_n,
                min_cut_len=min_cut_len, trim_palindrome=trim_pal,
                fwd=fwd, rev=rev),
        nat=dict(min_q=min_q, skip_n=skip_n, cut_n=cut_n,
                 min_cut_len=min_cut_len, trim_pal=trim_pal,
                 fwd=fwd, rev=rev),
    )


@pytest.mark.parametrize(
    "flags",
    [
        _flagmap(),
        _flagmap(rev=False),
        _flagmap(fwd=False),
        _flagmap(skip_n=True),
        _flagmap(cut_n=True, min_cut_len=3),
        _flagmap(cut_n=True, min_cut_len=1, trim_pal=True),
        _flagmap(trim_pal=True),
    ],
)
def test_reader_matches_python_line_mode(flags, rng, tmp_path):
    reads = random_reads(rng, n=40, lo=1, hi=20, with_n=True)
    reads += [[5, 5], [1, 4], [2, 3, 3, 2], [1], [4, 5, 4]]
    data = reads_to_lines(reads)
    a = python_batch(data, True, tmp_path, **flags["py"])
    b = native_batch(data, True, tmp_path, **flags["nat"])
    assert np.array_equal(a, b)


def test_reader_fastq_quality(rng, tmp_path):
    tab = "$ACGTN"
    out = []
    for i, r in enumerate(random_reads(rng, n=25, lo=5, hi=30)):
        seq = "".join(tab[c] for c in r)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 42, len(r)))
        out.append(f"@r{i} comment\n{seq}\n+\n{qual}\n")
    data = "".join(out).encode()
    f = _flagmap(min_q=20)
    a = python_batch(data, False, tmp_path, **f["py"])
    b = native_batch(data, False, tmp_path, **f["nat"])
    assert np.array_equal(a, b)


def test_reader_multiline_fasta(rng, tmp_path):
    tab = "$ACGTN"
    out = []
    for i, r in enumerate(random_reads(rng, n=10, lo=30, hi=80)):
        seq = "".join(tab[c] for c in r)
        wrapped = "\n".join(seq[j : j + 17] for j in range(0, len(seq), 17))
        out.append(f">r{i}\n{wrapped}\n")
    data = "".join(out).encode()
    f = _flagmap()
    a = python_batch(data, False, tmp_path, **f["py"])
    b = native_batch(data, False, tmp_path, **f["nat"])
    assert np.array_equal(a, b)


def _build(reads, so=0):
    eng = TpuBwt(so=so, K=16)
    eng.insert_multi(reads)
    return eng


def test_native_writers_match_python(rng, tmp_path):
    eng = _build(random_reads(rng, n=40, lo=5, hi=25, with_n=True), so=1)
    arr = eng.bwt_array()
    sym, ln = nlib.extract_runs(arr)
    assert [(int(s), int(l)) for s, l in zip(sym, ln)] == eng.runs()

    # text
    p = tmp_path / "t.txt"
    nlib.text_write(arr, str(p))
    assert p.read_bytes() == bwt_to_text(arr)

    # fmd
    p = tmp_path / "t.fmd"
    nlib.fmd_write(sym, ln, str(p))
    buf = io.BytesIO()
    write_fmd(eng.runs(), buf, log_summary=False)
    assert p.read_bytes() == buf.getvalue()

    # crlf
    p = tmp_path / "t.crlf"
    nlib.crlf_write(sym, ln, eng.counts(), str(p))
    buf = io.BytesIO()
    write_crlf(eng.runs(), eng.counts(), buf)
    assert p.read_bytes() == buf.getvalue()

    # fmr (deep tree to exercise multiple levels)
    import numpy as _np

    psize = _np.asarray(eng.state.psize)
    offs = _np.concatenate([[0], _np.cumsum(psize)]).astype(int)
    syms, lns, nruns = [], [], []
    for b in range(6):
        s, l2 = nlib.extract_runs(arr[offs[b] : offs[b + 1]])
        syms.append(s)
        lns.append(l2)
        nruns.append(len(s))
    p = tmp_path / "t.fmr"
    nlib.fmr_write(
        _np.concatenate(syms), _np.concatenate(lns),
        _np.asarray(nruns, dtype=_np.int64), eng.so, str(p),
        block_len=64, max_nodes=4,
    )
    buf = io.BytesIO()
    write_fmr(eng, buf, block_len=64, max_nodes=4)
    assert p.read_bytes() == buf.getvalue()


def test_concurrent_builds_do_not_collide(tmp_path):
    """Processes that build the library at once (test workers in a fresh
    checkout) must each end with a loadable library: every build writes
    its own temporary and renames it into place."""
    import subprocess
    import sys

    so = str(tmp_path / "_rb2host.so")
    code = (
        "import ctypes, ropebwt2_tpu.native.lib as l; "
        f"l._SO = {so!r}; l._build(); ctypes.CDLL(l._SO).rb2_count_runs"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stderr=subprocess.PIPE) for _ in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    assert sorted(os.listdir(tmp_path)) == ["_rb2host.so"]
