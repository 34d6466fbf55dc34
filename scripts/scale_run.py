"""Gsym-scale single-device capability run (VERDICT item 4).

Builds the BWT of SCALE_NREADS x SCALE_L random reads (default 10.4M x 101bp
= 1.06 Gsym with sentinels) on the attached device in SCALE_MBATCH-read
batches, printing per-batch wall times and cumulative throughput, and writes
the result JSON to SCALE_JSON when it is set.

Self-checks: final symbol counts (sentinels == #reads, total == Gsym), and
an FM-query spot check (backward_search of sampled read substrings must hit
at least the planted multiplicity).  With SCALE_MD5=1 the full BWT is
pulled back and md5-hashed in the reference's plain-text encoding; compare
against `ropebwt2 -LRs -m10g` on the same reads (generate them with
scripts/gen_scale_input.py — same RNG stream).  RLO output is insertion-
order invariant (README.md:15-25), so batching does not affect the hash.

Env: SCALE_NREADS (default 10_485_760), SCALE_L (101), SCALE_MBATCH
(default 2^21), SCALE_SO (1=RLO), SCALE_JSON (output path), SCALE_MD5=1.
tests/golden_md5.json holds the reference-verified md5s of such runs.
Read-set shape (scripts/readgen.py): SCALE_DATA=uniform|coverage,
SCALE_COV (47), SCALE_ERR (0.01), SCALE_SEED (12345).  Index tier:
ROPEBWT2_TPU_RUNS / ROPEBWT2_TPU_PACK4 (engine envs).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    nreads = int(os.environ.get("SCALE_NREADS", 10_485_760))
    L = int(os.environ.get("SCALE_L", 101))
    mbatch = int(os.environ.get("SCALE_MBATCH", 1 << 21))
    so = int(os.environ.get("SCALE_SO", 1))
    out_path = os.environ.get("SCALE_JSON")

    import jax
    from ropebwt2_tpu.engine import TpuBwt

    dev = jax.devices()[0]
    total_syms = nreads * (L + 1)
    print(f"[scale] {nreads} reads x {L} bp = {total_syms/1e9:.3f} Gsym "
          f"on {dev.platform}:{dev.device_kind}, batches of {mbatch}",
          flush=True)

    eng = TpuBwt(so=so)
    eng._plan(total_syms)  # allocate final capacity once (no regrowth copies)
    print(f"[scale] capacity {eng.state.cap/1e9:.3f} Gsym "
          f"(pos dtype {'int32' if eng.state.cap < (1 << 31) - 1 else 'int64'})",
          flush=True)

    import readgen

    gen = readgen.from_env(None, nreads, L, mbatch)
    t0 = time.time()
    batch_walls = []
    done = 0
    while done < nreads:
        m = min(mbatch, nreads - done)
        reads = gen.batch(m).view(np.int8)
        tb = time.time()
        eng.insert_multi(reads)
        cnt = eng.counts()  # device->host pull: the sync point
        wall = time.time() - tb
        done += m
        batch_walls.append(round(wall, 2))
        thr = done * (L + 1) / (time.time() - t0)
        print(f"[scale] batch {len(batch_walls)}: {m} reads in {wall:.1f}s | "
              f"n={int(cnt.sum())/1e9:.3f} Gsym | cum {thr/1e6:.2f} Msym/s",
              flush=True)
        assert int(cnt[0]) == done, (cnt[0], done)
        assert int(cnt.sum()) == done * (L + 1)

    wall_total = time.time() - t0

    # parity with `ropebwt2 -L` on the same reads as a text file: when the
    # text-stream length is an exact multiple of kseq's 16384-byte buffer,
    # the reference parses one phantom empty read (kstream quirk, see
    # io/seqio.py) — mirror it before hashing
    if (nreads * (L + 1)) % 16384 == 0:
        eng.insert_multi([np.zeros(0, np.int8)])
        print("[scale] inserted phantom empty read (kseq boundary quirk)",
              flush=True)

    bwt_md5 = None
    if os.environ.get("SCALE_MD5") == "1":
        # md5 of the reference's plain-text encoding ("$ACGTN" chars + one
        # trailing newline), BEFORE the probe batch below mutates the index
        import hashlib

        tm = time.time()
        h = hashlib.md5()
        lut = np.frombuffer(b"$ACGTN", dtype=np.uint8)
        bwt = eng.bwt_array()  # one big device->host pull
        for lo in range(0, bwt.shape[0], 1 << 26):
            h.update(lut[bwt[lo : lo + (1 << 26)]].tobytes())
        h.update(b"\n")
        bwt_md5 = h.hexdigest()
        print(f"[scale] bwt md5 {bwt_md5} ({time.time()-tm:.1f}s incl. "
              "transfer)", flush=True)

    # FM-index spot check: planted substrings must be found
    from ropebwt2_tpu.engine.query import backward_search

    probe = gen.rng.integers(1, 5, size=(4, 12)).astype(np.int8)
    # plant each probe in a tiny extra batch so occurrence >= 1 is guaranteed
    eng.insert_multi(list(probe))
    lo, hi = backward_search(
        eng.state,
        probe.astype(np.int32),
        np.full(probe.shape[0], probe.shape[1], dtype=np.int32),
    )
    found = np.asarray(hi - lo)
    assert (found >= 1).all(), found
    print(f"[scale] FM spot check ok: occurrences {found.tolist()}", flush=True)

    # the first batch carries the compile; report it separately, alongside
    # the all-in number
    warm = batch_walls[0] if batch_walls else 0.0
    steady_syms = total_syms - (total_syms // max(len(batch_walls), 1))
    steady_wall = max(wall_total - warm, 1e-9)
    result = {
        "metric": "bcr_scale_run",
        "symbols": total_syms,
        "reads": nreads,
        "read_len": L,
        "sorting_order": so,
        "wall_s": round(wall_total, 1),
        "throughput_sym_s": round(total_syms / wall_total, 1),
        "warmup_s": round(warm, 1),
        "steady_throughput_sym_s": round(steady_syms / steady_wall, 1),
        "device": f"{dev.platform}:{dev.device_kind}",
        "batch_walls_s": batch_walls,
        "capacity": eng.state.cap,
        "data": {
            "mode": os.environ.get("SCALE_DATA", "uniform"),
            "cov": float(os.environ.get("SCALE_COV", 47.0)),
            "err": float(os.environ.get("SCALE_ERR", 0.01)),
        },
    }
    if hasattr(eng.state, "nslot"):
        ns = int(eng.state.nslot)
        result["index_tier"] = "runs"
        result["run_slots"] = ns
        result["sym_per_run"] = round(total_syms / max(ns, 1), 2)
        result["index_bytes_per_sym"] = round(5.0 * ns / total_syms, 4)
    if bwt_md5 is not None:
        result["bwt_md5"] = bwt_md5
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print("[scale] RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
