"""Smoke run of the BWT build on one GPU, checked against recorded md5s.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # only the sharded engine on 4 cards

Phases (one process; any failure exits non-zero):

1. numerics  the exact f32 contractions (cumsum_blocked's window matmul,
             the plan's one-hot row selects) against integer references
             at 2^20 rows with values above 2^11, where TF32 would round;
2. golden    the 1.07 Gsym coverage read set of tests/golden_md5.json
             ("scale_r05") through TpuBwt(so=1) in 2^18-read batches;
             md5 of the plain-text BWT against the reference's, then the
             planted-probe backward_search check;
3. tiers     2^20 reads of the same shape on the flat, 4-bit packed and
             run-length tiers: byte-equal BWTs;
4. cli       a seeded FASTQ.gz through cli.main() in this process (native
             reader, -m batches) in six output formats, md5s against the
             "cli" fixtures;
5. queries   rank, extend and backward_search over the phase-2 index
             against host counts over the host copy of the BWT.

The last stdout line is one JSON object with the device JAX reports.  The
script refuses to run without a GPU: there is no CPU fallback.
"""

import argparse
import gzip
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden_md5.json")
LUT = np.frombuffer(b"$ACGTN", dtype=np.uint8)

# phase-3 and --four-cards read sets: coverage reads of the golden shape
TIER_READS, TIER_BATCH = 1 << 20, 1 << 18
# phase-4 input and flags (fixtures in GOLDEN["cli"])
CLI_READS, CLI_SEED, CLI_BATCH = 2600, 2024, "128k"
CLI_FORMATS = {
    "text_io": ["-R"],
    "text_rlo": ["-Rs"],
    "text_rclo": ["-Rr"],
    "fmr": ["-Rsb"],
    "fmd": ["-Rsd"],
    "crlf": ["-RsB"],
}


def log(msg):
    print(msg, flush=True)


def text_md5(bwt):
    """md5 of the plain-text BWT (`ropebwt2 -LR` stdout): '$ACGTN' per
    symbol plus one trailing newline."""
    h = hashlib.md5()
    for lo in range(0, bwt.shape[0], 1 << 26):
        h.update(LUT[bwt[lo : lo + (1 << 26)]].tobytes())
    h.update(b"\n")
    return h.hexdigest()


def write_cli_input(path):
    """Seeded FASTQ.gz for the CLI phase: ragged 40-150 bp coverage reads
    with sparse Ns and random qualities."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import readgen

    gen = readgen.ReadGen(seed=CLI_SEED, nreads=CLI_READS, L=150,
                          mode="coverage", cov=20.0, err=0.01)
    reads = gen.batch(CLI_READS)
    rng = np.random.default_rng(CLI_SEED)
    lens = rng.integers(40, 151, CLI_READS)
    reads[rng.random(reads.shape) < 0.002] = 5
    out = []
    for i in range(CLI_READS):
        seq = LUT[reads[i, : lens[i]]].tobytes().decode()
        qual = "".join(chr(33 + q) for q in rng.integers(2, 41, lens[i]))
        out.append(f"@r{i}\n{seq}\n+\n{qual}\n")
    with open(path, "wb") as f:
        with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as g:
            g.write("".join(out).encode())


def cli_md5s(workdir):
    """{format: md5 of the CLI's output file} for the phase-4 input."""
    from ropebwt2_tpu import cli

    fq = os.path.join(workdir, "in.fq.gz")
    write_cli_input(fq)
    got = {}
    for name, flags in CLI_FORMATS.items():
        out = os.path.join(workdir, name + ".out")
        rc = cli.main(flags + ["-m", CLI_BATCH, "-v", "1", "-o", out, fq])
        assert rc == 0, (name, rc)
        with open(out, "rb") as f:
            got[name] = hashlib.md5(f.read()).hexdigest()
    return got


class HostRank:
    """rank over a host copy of the BWT: per-symbol counts at every 2^16
    boundary plus a bincount of the remainder."""

    STEP = 1 << 16

    def __init__(self, bwt):
        self.bwt = bwt
        starts = np.arange(0, bwt.shape[0], self.STEP)
        cp = np.zeros((starts.shape[0] + 1, 6), np.int64)
        for s in range(6):
            cp[1:, s] = np.cumsum(
                np.add.reduceat((bwt == s).view(np.uint8), starts,
                                dtype=np.int64))
        self.cp = cp
        self.C = np.concatenate([[0], np.cumsum(cp[-1])])

    def __call__(self, p):
        k = p // self.STEP
        tail = np.bincount(self.bwt[k * self.STEP : p], minlength=7)[:6]
        return self.cp[k] + tail

    def backward_search(self, pat):
        lo, hi = 0, int(self.C[6])
        for a in pat[::-1]:
            lo = int(self.C[a] + self(lo)[a])
            hi = int(self.C[a] + self(hi)[a])
        return lo, hi


def phase_numerics():
    import jax
    import jax.numpy as jnp

    from ropebwt2_tpu.engine.bcr import onehot_rows
    from ropebwt2_tpu.index.scan import cumsum_blocked

    rng = np.random.default_rng(1)
    # sparse values above 2^11 (TF32 keeps 11 significant bits), one per
    # ~256 rows so every window sum of every scan level stays below 2^24
    x = np.where(rng.random((1 << 20, 6)) < 1 / 256,
                 rng.integers((1 << 11) + 1, 1 << 13, (1 << 20, 6)),
                 rng.integers(0, 2, (1 << 20, 6))).astype(np.int64)
    got = np.asarray(jax.jit(cumsum_blocked)(jnp.asarray(x)))
    assert np.array_equal(got, np.cumsum(x, axis=0)), "cumsum_blocked"
    c = rng.integers(0, 6, 1 << 20)
    table = rng.integers(1 << 11, (1 << 31) - 1, (6, 7)).astype(np.int32)
    ohf = jnp.asarray((c[:, None] == np.arange(6)).astype(np.float32))
    got = np.asarray(jax.jit(onehot_rows)(ohf, jnp.asarray(table)))
    assert np.array_equal(got, table[c]), "onehot_rows"
    log("[numerics] cumsum_blocked and onehot_rows exact at 2^20 rows")


def golden_build():
    """Phase 2.  Returns (engine, host BWT, read generator)."""
    import jax

    import readgen
    from ropebwt2_tpu.engine import TpuBwt

    g = json.load(open(GOLDEN))["builds"]["scale_r05"]
    nreads, L, mb = g["nreads"], g["L"], g["mbatch"]
    gen = readgen.ReadGen(seed=g["seed"], nreads=nreads, L=L,
                          mode=g["mode"], cov=g["cov"], err=g["err"])
    eng = TpuBwt(so=g["so"])
    eng._plan(g["symbols"])  # one allocation for the whole build
    defer_r, pcap = eng._choose_defer(mb)
    log(f"[golden] tier {type(eng.state).__name__} cap {eng.state.cap} "
        f"defer_r {defer_r} pcap {pcap}")
    walls, gen_s = [], 0.0
    for _ in range(nreads // mb):
        t0 = time.perf_counter()
        reads = gen.batch(mb).view(np.int8)
        t1 = time.perf_counter()
        eng.insert_multi(reads)
        jax.block_until_ready(eng.state)
        gen_s += t1 - t0
        walls.append(time.perf_counter() - t1)
    steady = walls[1:]
    log(f"[golden] first batch (compile + run) {walls[0]:.3f} s")
    log(f"[golden] steady batch walls s (insert_multi, synced): median "
        f"{np.median(steady):.4f} min {min(steady):.4f} max {max(steady):.4f}"
        f" (all: {' '.join(f'{w:.3f}' for w in steady)})")
    log(f"[golden] build wall {sum(walls):.3f} s for {g['symbols']} symbols "
        f"(+ {gen_s:.1f} s of host read generation); steady "
        f"{(len(steady) * mb * (L + 1)) / sum(steady):.1f} sym/s")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[golden] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    if g["phantom_empty_read"]:
        eng.insert_multi([np.zeros(0, np.int8)])
    t0 = time.perf_counter()
    bwt = eng.bwt_array()
    md5 = text_md5(bwt)
    log(f"[golden] md5 {md5} (want {g['md5']}) "
        f"{time.perf_counter() - t0:.1f} s incl. transfer")
    assert bwt.shape[0] == g["symbols"] + g["phantom_empty_read"]
    assert md5 == g["md5"], "golden md5 mismatch"
    return eng, bwt, gen


def planted_probes(eng, gen):
    from ropebwt2_tpu.engine.query import backward_search

    probe = gen.rng.integers(1, 5, size=(4, 12)).astype(np.int8)
    eng.insert_multi(list(probe))
    lo, hi = backward_search(
        eng.state, probe.astype(np.int32),
        np.full(probe.shape[0], probe.shape[1], dtype=np.int32),
    )
    found = np.asarray(hi - lo)
    assert (found >= 1).all(), found
    log(f"[golden] planted probes found {found.tolist()}")


def phase_queries(eng, bwt, gen):
    import jax.numpy as jnp

    from ropebwt2_tpu.engine.query import backward_search, extend, rank1a

    t0 = time.perf_counter()
    hr = HostRank(bwt)
    n = bwt.shape[0]
    rng = np.random.default_rng(3)
    pos = np.concatenate([[0, n], rng.integers(0, n + 1, 2046)])
    got = np.asarray(rank1a(eng.state, jnp.asarray(pos)))
    want = np.stack([hr(int(p)) for p in pos])
    assert np.array_equal(got, want), "rank1a"

    x0 = rng.integers(0, n - 64, 256)
    ik = np.stack([x0, rng.integers(0, n, 256), rng.integers(0, 64, 256)], 1)
    got = np.asarray(extend(eng.state, jnp.asarray(ik)))
    for q in range(ik.shape[0]):
        tk, tl = hr(int(ik[q, 0])), hr(int(ik[q, 0] + ik[q, 2]))
        size = tl - tk
        other = np.zeros(6, np.int64)
        other[0] = ik[q, 1]
        for a, b in ((4, 0), (3, 4), (2, 3), (1, 2), (5, 1)):
            other[a] = other[b] + size[b]
        want = np.stack([hr.C[:6] + tk, other, size], axis=1)
        assert np.array_equal(got[q], want), ("extend", q)

    starts = rng.integers(0, gen.genome.shape[0] - 16, 128)
    pats = np.stack([gen.genome[s : s + 16] for s in starts]).astype(np.int32)
    lens = rng.integers(8, 17, 128)
    right = np.zeros_like(pats)  # right-aligned at the last column
    for q in range(128):
        right[q, 16 - lens[q] :] = pats[q, : lens[q]]
    lo, hi = backward_search(eng.state, jnp.asarray(right),
                             jnp.asarray(lens.astype(np.int32)))
    lo, hi = np.asarray(lo), np.asarray(hi)
    for q in range(128):
        want = hr.backward_search(pats[q, : lens[q]])
        assert (int(lo[q]), int(hi[q])) == want, ("backward_search", q)
    log(f"[queries] rank1a x{pos.shape[0]}, extend x{ik.shape[0]}, "
        f"backward_search x128 (median hits {int(np.median(hi - lo))}) "
        f"equal to host counts in {time.perf_counter() - t0:.1f} s")


def tier_reads(seed):
    import readgen

    gen = readgen.ReadGen(seed=seed, nreads=TIER_READS, L=101,
                          mode="coverage", cov=47.0, err=0.01)
    return [gen.batch(TIER_BATCH).view(np.int8)
            for _ in range(TIER_READS // TIER_BATCH)]


def build_tier(batches, env):
    from ropebwt2_tpu.engine import TpuBwt

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        eng = TpuBwt(so=1)
        eng._plan(sum(b.shape[0] * (b.shape[1] + 1) for b in batches))
        t0 = time.perf_counter()
        for b in batches:
            eng.insert_multi(b)
        out = eng.bwt_array()
        return out, type(eng.state).__name__, time.perf_counter() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_tiers():
    batches = tier_reads(777)
    flat, name, s = build_tier(batches, {"ROPEBWT2_TPU_PACK4": "0",
                                         "ROPEBWT2_TPU_RUNS": "0"})
    assert name == "FlatBwt", name
    log(f"[tiers] {name} {flat.shape[0]} symbols in {s:.1f} s")
    for env, want in (({"ROPEBWT2_TPU_PACK4": "1"}, "PackedFlatBwt"),
                      ({"ROPEBWT2_TPU_RUNS": "1"}, "RunBwt")):
        got, name, s = build_tier(batches, env)
        assert name == want, name
        assert np.array_equal(got, flat), f"{name} BWT differs from flat"
        log(f"[tiers] {name} byte-equal to FlatBwt in {s:.1f} s")


def phase_cli():
    from ropebwt2_tpu.native import native_available

    assert native_available(), "the native reader did not build"
    want = json.load(open(GOLDEN))["cli"]["md5"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        got = cli_md5s(d)
    for name in CLI_FORMATS:
        assert got[name] == want[name], (name, got[name], want[name])
    log(f"[cli] {', '.join(CLI_FORMATS)} md5s equal to the fixtures in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_four_cards():
    """ShardedTpuBwt over a 4-card mesh against TpuBwt on one card, then
    the graft entry's multi-device dry run."""
    import jax

    import __graft_entry__
    from ropebwt2_tpu.engine import TpuBwt
    from ropebwt2_tpu.parallel.mesh import make_mesh
    from ropebwt2_tpu.parallel.sharded import AXIS, ShardedTpuBwt

    assert len(jax.devices()) >= 4, jax.devices()
    batches = tier_reads(99)
    walls = {}
    for name, eng in (("sharded", ShardedTpuBwt(so=1,
                                                mesh=make_mesh(4, AXIS))),
                      ("single", TpuBwt(so=1))):
        t0 = time.perf_counter()
        for b in batches:
            eng.insert_multi(b)
        out = eng.bwt_array()
        walls[name] = time.perf_counter() - t0
        if name == "sharded":
            sharded = out
    assert np.array_equal(sharded, out), "sharded BWT differs"
    log(f"[four-cards] sharded BWT of {out.shape[0]} symbols byte-equal to "
        f"one card (walls incl. compile: sharded {walls['sharded']:.1f} s, "
        f"single {walls['single']:.1f} s)")
    __graft_entry__.dryrun_multichip(4)
    log("[four-cards] dryrun_multichip(4) ok")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine on four cards")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))

    import jax

    import ropebwt2_tpu  # noqa: F401  (x64 + compile cache)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX found {devs})\n")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}"
        f", XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_numerics()
        eng, bwt, gen = golden_build()
        phase_queries(eng, bwt, gen)
        planted_probes(eng, gen)
        del eng, bwt
        phase_tiers()
        phase_cli()
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
