"""Long-read (Moleculo-regime) capability artifact — VERDICT r03 item 7.

The reference's headline differentiator is kbp+ reads (tex/ropebwt2.tex:263-267;
Moleculo 22.7M reads, ~4 kbp avg, README.md:186): BCR pays one round per
symbol COLUMN, so long reads mean many rounds over a small active set —
exactly where per-round fixed cost dominates.  This run builds the RLO BWT
of LR_NREADS reads with lengths uniform in [LR_MIN, LR_MAX] (default
10–20 kbp — config #4's 10–100 kbp band) on the attached device,
md5-checks the plain-text BWT against `ropebwt2 -LRs` on the same reads
(RLO output is insertion-order invariant; tests/golden_md5.json records the
reference's md5 for two such read sets), and writes LR_JSON when set.

Env: LR_NREADS (default 32768), LR_MIN (10000), LR_MAX (20000),
LR_SO (1), LR_JSON, LR_REF (reference binary path; skip md5 if absent),
LR_DEFER (defer_r override; default auto).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    nreads = int(os.environ.get("LR_NREADS", 32768))
    lo = int(os.environ.get("LR_MIN", 10000))
    hi = int(os.environ.get("LR_MAX", 20000))
    so = int(os.environ.get("LR_SO", 1))
    ref = os.environ.get("LR_REF", "/tmp/ropebwt2_ref/ropebwt2")
    out_path = os.environ.get("LR_JSON")
    defer = os.environ.get("LR_DEFER")

    import jax
    from ropebwt2_tpu.engine import TpuBwt

    rng = np.random.default_rng(4242)
    lens = rng.integers(lo, hi + 1, size=nreads)
    total = int(lens.sum()) + nreads
    dev = jax.devices()[0]
    print(f"[longread] {nreads} reads x [{lo},{hi}] bp = "
          f"{total/1e9:.3f} Gsym on {dev.platform}:{dev.device_kind}",
          flush=True)

    # one ragged batch (the reference would batch by -m bytes; a single
    # batch is the honest worst case for round count: rounds = max len + 1)
    reads = [rng.integers(1, 5, size=int(ln), dtype=np.uint8).view(np.int8)
             for ln in lens]

    eng = TpuBwt(so=so, defer_r=int(defer) if defer else None)
    eng._plan(total)
    t0 = time.time()
    eng.insert_multi(reads)
    cnt = eng.counts()
    wall = time.time() - t0
    assert int(cnt[0]) == nreads and int(cnt.sum()) == total, cnt
    thr = total / wall
    print(f"[longread] built in {wall:.1f}s = {thr/1e6:.2f} Msym/s "
          f"({int(lens.max())+1} rounds)", flush=True)

    # md5 parity vs the reference binary on the same reads
    md5 = hashlib.md5()
    lut = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    bwt = eng.bwt_array()
    for s in range(0, bwt.shape[0], 1 << 26):
        md5.update(lut[bwt[s : s + (1 << 26)]].tobytes())
    md5.update(b"\n")
    got = md5.hexdigest()
    want = None
    if os.path.exists(ref):
        lines = bytearray()
        for r in reads:
            lines += lut[r].tobytes() + b"\n"
        t1 = time.time()
        p = subprocess.run(
            [ref, "-LRs" if so == 1 else "-LR", "-"],
            input=bytes(lines), stdout=subprocess.PIPE, check=True,
        )
        want = hashlib.md5(p.stdout).hexdigest()
        print(f"[longread] reference wall {time.time()-t1:.1f}s", flush=True)
        assert got == want, (got, want)
        print("[longread] md5 parity OK", flush=True)

    result = {
        "metric": "longread_build",
        "reads": nreads,
        "len_range": [lo, hi],
        "symbols": total,
        "sorting_order": so,
        "wall_s": round(wall, 1),
        "throughput_sym_s": round(thr, 1),
        "rounds": int(lens.max()) + 1,
        "device": f"{dev.platform}:{dev.device_kind}",
        "bwt_md5": got,
        "md5_matches_reference": (want == got) if want else None,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print("[longread] RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
