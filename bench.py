#!/usr/bin/env python
"""Benchmark: BCR construction + FM-query throughput on the attached GPU.

Reports BOTH construction regimes plus the query metric (BASELINE.json's
metric is "symbols inserted/sec/chip; rank queries/sec"):

* sustained — the HEADLINE `value`: batches inserted into an index
  prefilled to PREFILL_X times the batch, i.e. the steady-state regime a
  full build spends its time in (the regime the reference's worm wall
  number measures; chip_smoke.py's golden build is the Gsym-scale version).
* batch regime — one batch into an EMPTY index (live prefix ~ batch),
  kept in detail: a more flattering number, since merge traffic scales
  with the batch.
* rank queries/sec — batched 6-symbol rank over the built index.

Read shape: BENCH_DATA=coverage (default) samples reads from one genome
at 47x with 1% substitution errors — the statistical shape of the
reference's own benchmark datasets (worm = 66.8M x 100 bp over ~100 Mbp
~= 47x resequencing, README.md:139-152).  BENCH_DATA=uniform gives the
i.i.d.-random reads earlier rounds measured (no shared suffixes: rank
U-end skips fire more, but it is not the baseline's workload).

Baseline: the reference's worm RLO row (66.8M x 100bp in 506 s wall on a
48-core Xeon = 13.2 Msym/s, BASELINE.md).  Prints exactly one JSON line.

The device work runs in a watchdog subprocess that STREAMS a RESULT line
after every stage (warmup, each timed run, the sustained stage, the query
stages — each strictly richer); the parent keeps the freshest line, kills
the child shortly before the budget expires, and reports the best seen.
The parent imports no JAX (the child owns the card) and adds the card's
name and power limit from nvidia-smi to the result.  Without a GPU the
child exits non-zero and the result carries an error: there is no CPU
fallback.

Env knobs: BENCH_M (#reads), BENCH_L (read length), BENCH_SO (0/1/2),
BENCH_RUNS (timed runs, default 5), BENCH_PREFILL_X (default 8),
BENCH_SUSTAIN_RUNS (default 2), BENCH_TIMEOUT (seconds, default 1500),
BENCH_K (block size, default 128 = the engine default), BENCH_DATA
(coverage|uniform), BENCH_COV (47), BENCH_ERR (0.01).
"""

import json
import os
import subprocess
import sys
import threading
import time

BASELINE = 13.2e6  # ropebwt2 worm-RLO wall symbols/s (BASELINE.md)
METRIC = "bcr_insert_throughput_rlo"


def inner():
    import numpy as np

    M = int(os.environ.get("BENCH_M", 1 << 17))
    L = int(os.environ.get("BENCH_L", 101))
    so = int(os.environ.get("BENCH_SO", 1))
    runs = int(os.environ.get("BENCH_RUNS", 5))
    K = int(os.environ.get("BENCH_K", 128))
    prefill_x = int(os.environ.get("BENCH_PREFILL_X", 8))
    sustain_runs = int(os.environ.get("BENCH_SUSTAIN_RUNS", 2))

    import jax

    from ropebwt2_tpu.engine import TpuBwt

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"[bench] no GPU: JAX found {jax.devices()}")

    data_mode = os.environ.get("BENCH_DATA", "coverage")
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from readgen import ReadGen

    nbatches = 1 + prefill_x + sustain_runs
    gen = ReadGen(
        seed=0, nreads=M * nbatches, L=L, mode=data_mode,
        cov=float(os.environ.get("BENCH_COV", 47.0)),
        err=float(os.environ.get("BENCH_ERR", 0.01)),
    )
    # batch-regime reads reused across timed runs; sustained batches drawn
    # fresh (a prefilled coverage index must not see literal repeats)
    rng = np.random.default_rng(1)  # query-stage positions/patterns
    reads = gen.batch(M).view(np.int8)
    syms = M * (L + 1)
    dev = jax.devices()[0]
    devs = f"{dev.platform}:{dev.device_kind}"

    def run():
        eng = TpuBwt(so=so, K=K)
        t0 = time.time()
        eng.insert_multi(reads)
        cnt = eng.counts()  # device->host pull: the sync point
        dt = time.time() - t0
        assert int(cnt[0]) == M and int(cnt.sum()) == syms, "self-check failed"
        return dt

    state = {"batch_t": None, "batch_runs": 0, "degraded": None,
             "sustained": None, "rank": None, "warmup_s": None,
             "extend": None, "bsearch": None}

    def report():
        t = state["batch_t"]
        detail = {
            "reads": M,
            "read_len": L,
            "sorting_order": so,
            "K": K,
            "device": devs,
            "data": data_mode,
            "baseline":
                "ropebwt2 -brRm10g worm 13.2 Msym/s wall (README.md:176)",
            "batch": {
                "value": round(syms / t, 1),
                "unit": "symbols/s/chip",
                "vs_baseline": round(syms / t / BASELINE, 3),
                "wall_s": round(t, 4),
                "timed_runs": state["batch_runs"],
                "regime": "one batch into an empty index (the r01-r04 "
                          "top-level value; flattering — merge traffic ~ "
                          "batch size)",
            },
        }
        if state["sustained"] is not None:
            sv = state["sustained"]
            value = sv["thr"]
            detail["regime"] = (
                f"sustained: batches into a ~{prefill_x}x-batch "
                "prefilled index (steady-state of a full build)"
            )
            detail["prefill_symbols"] = sv["prefill_sym"]
            detail["timed_batches"] = sv["batches"]
        else:
            value = syms / t
            detail["regime"] = (
                "batch (sustained stage pending; value will switch to "
                "the sustained number)"
            )
        if state["warmup_s"] is not None:
            detail["warmup_s"] = round(state["warmup_s"], 1)
        if state["rank"] is not None:
            rv = state["rank"]
            detail["rank_queries"] = {
                "value": round(rv["qps"], 1),
                "unit": "queries/s/chip (6-symbol rank, batched)",
                "index_symbols": rv["n"],
                "batch_queries": rv["q"],
            }
        if state["extend"] is not None:
            ev = state["extend"]
            detail["extend"] = {
                "value": round(ev["qps"], 1),
                "unit": "bi-interval extensions/s/chip (rld_extend batched)",
                "batch_queries": ev["q"],
            }
        if state["bsearch"] is not None:
            bv = state["bsearch"]
            detail["backward_search"] = {
                "value": round(bv["sps"], 1),
                "unit": "pattern symbols/s/chip (backward search steps)",
                "patterns": bv["q"],
                "pattern_len": bv["plen"],
            }
        obj = {
            "metric": METRIC,
            "value": round(value, 1),
            "unit": "symbols/s/chip",
            "vs_baseline": round(value / BASELINE, 3),
            "detail": detail,
        }
        if state["degraded"]:
            obj["degraded"] = state["degraded"]
        print("RESULT " + json.dumps(obj), flush=True)

    t_warm = run()  # compile (persistent-cached) + run
    print(f"[bench] warmup(+compile): {t_warm:.1f}s on {devs}",
          file=sys.stderr)
    state["batch_t"] = t_warm
    state["warmup_s"] = t_warm
    state["degraded"] = "warmup-includes-compile"
    report()
    best = None
    for i in range(runs):
        t = run()
        best = t if best is None else min(best, t)
        print(f"[bench] run {i + 1}/{runs}: {t:.3f}s (best {best:.3f}s)",
              file=sys.stderr)
        state["batch_t"] = best
        state["batch_runs"] = i + 1
        state["degraded"] = "batch-stage-partial" if i < runs - 1 else \
            "sustained-stage-pending"
        report()

    # ---- sustained regime (fresh coverage batches each step) ----
    eng = TpuBwt(so=so, K=K)
    eng._plan((prefill_x + sustain_runs + 1) * syms)
    t0 = time.time()
    for i in range(prefill_x):
        eng.insert_multi(gen.batch(M).view(np.int8))
    eng.counts()
    print(f"[bench] prefill {prefill_x} batches: {time.time()-t0:.1f}s",
          file=sys.stderr)
    walls = []
    for i in range(sustain_runs):
        sreads = gen.batch(M).view(np.int8)
        t0 = time.time()
        eng.insert_multi(sreads)
        eng.counts()
        walls.append(time.time() - t0)
        print(f"[bench] sustained run {i+1}/{sustain_runs}: {walls[-1]:.2f}s",
              file=sys.stderr)
    state["sustained"] = {
        "thr": syms / min(walls),
        "prefill_sym": prefill_x * syms,
        "batches": sustain_runs,
    }
    state["degraded"] = "rank-stage-pending"
    report()

    # ---- rank queries/sec over the built index ----
    import jax.numpy as jnp

    from ropebwt2_tpu.index.rank import rank_global

    n = int(eng.counts().sum())
    Q = 1 << 18
    iters = 32
    qpos = jnp.asarray(
        np.sort(rng.integers(0, n, Q)).astype(np.int32)
    )
    st = eng.state

    # big device arrays are jit arguments, not constants baked into the
    # compiled program
    @jax.jit
    def qloop(bwt, blk, g):
        def body(i, g):
            occ = rank_global(bwt, blk, g, K)
            return jnp.clip(g + (occ[:, 0] & 1), 0, n - 1)
        return jax.lax.fori_loop(0, iters, body, g)

    np.asarray(qloop(st.bwt, st.blk_prefix, qpos))  # compile + run
    best_q = None
    for _ in range(3):
        t0 = time.time()
        np.asarray(qloop(st.bwt, st.blk_prefix, qpos))
        dt = time.time() - t0
        best_q = dt if best_q is None else min(best_q, dt)
    state["rank"] = {"qps": Q * iters / best_q, "n": n, "q": Q}
    state["degraded"] = "extend-stage-pending"
    print(f"[bench] rank: {Q*iters/best_q/1e6:.1f} Mq/s over n={n/1e6:.0f}M",
          file=sys.stderr)
    report()

    # ---- extend (rld_extend) throughput: chained backward extensions ----
    from ropebwt2_tpu.index.scan import cumsum_small

    pdt = st.blk_prefix.dtype
    Cvec = jnp.concatenate(
        [jnp.zeros(1, jnp.int64), cumsum_small(st.pcounts.sum(axis=0))]
    ).astype(pdt)

    @jax.jit
    def eloop(bwt, blk, ik):
        # inline rld_extend's backward step (engine/query.py:extend) so the
        # big arrays ride as jit ARGUMENTS and the chain re-feeds each
        # step's symbol-a interval
        def body(i, ik):
            p = ik[:, 0]
            tk = rank_global(bwt, blk, p, K)
            tl = rank_global(bwt, blk, jnp.minimum(p + ik[:, 2], n), K)
            size = tl - tk
            a = (i % 4) + 1
            x0 = Cvec[a] + tk[:, a]
            keep = ik[:, 1]
            sz = jnp.maximum(size[:, a], 1)  # keep the chain alive
            return jnp.stack([x0, keep, sz], axis=1)

        return jax.lax.fori_loop(0, iters, body, ik)

    ik0 = jnp.stack(
        [
            jnp.asarray(np.sort(rng.integers(0, n - 200, Q)), pdt),
            jnp.zeros(Q, pdt),
            jnp.full(Q, 100, pdt),
        ],
        axis=1,
    )
    np.asarray(eloop(st.bwt, st.blk_prefix, ik0))
    best_e = None
    for _ in range(3):
        t0 = time.time()
        np.asarray(eloop(st.bwt, st.blk_prefix, ik0))
        dt = time.time() - t0
        best_e = dt if best_e is None else min(best_e, dt)
    state["extend"] = {"qps": Q * iters / best_e, "q": Q}
    state["degraded"] = "bsearch-stage-pending"
    print(f"[bench] extend: {Q*iters/best_e/1e6:.1f} M ext/s",
          file=sys.stderr)
    report()

    # ---- backward_search throughput (the fermi consumption pattern) ----
    from ropebwt2_tpu.engine.query import backward_search

    Qb, plen = 1 << 16, 31
    pats = rng.integers(1, 5, size=(Qb, plen)).astype(np.int32)
    plens = np.full(Qb, plen, dtype=np.int32)
    lo, hi = backward_search(st, jnp.asarray(pats), jnp.asarray(plens))
    np.asarray(lo)
    best_b = None
    for _ in range(3):
        t0 = time.time()
        lo, hi = backward_search(st, jnp.asarray(pats), jnp.asarray(plens))
        np.asarray(hi)
        dt = time.time() - t0
        best_b = dt if best_b is None else min(best_b, dt)
    state["bsearch"] = {"sps": Qb * plen / best_b, "q": Qb, "plen": plen}
    state["degraded"] = None
    print(f"[bench] backward_search: {Qb*plen/best_b/1e6:.1f} M sym-steps/s",
          file=sys.stderr)
    report()


def run_child(extra_env, deadline):
    """Run the inner benchmark, harvesting RESULT lines as they stream;
    returns (last_result_json_str_or_None, exit_status)."""
    env = dict(os.environ)
    env["ROPEBWT2_TPU_BENCH_INNER"] = "1"
    env.update(extra_env)
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=env, stdout=subprocess.PIPE, stderr=sys.stderr, text=True,
    )
    last = [None]

    def reader():
        for line in p.stdout:
            if line.startswith("RESULT "):
                last[0] = line[len("RESULT "):].strip()

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    while True:
        rc = p.poll()
        if rc is not None:
            th.join(5)
            return last[0], rc
        if time.time() > deadline:
            p.kill()
            th.join(5)
            return last[0], "timeout"
        time.sleep(1)


def card_name_and_power_limit():
    """nvidia-smi's 'name, power.limit' line (the parent stays off JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def main():
    timeout = float(os.environ.get("BENCH_TIMEOUT", 1500))
    t0 = time.time()
    result, rc = run_child({}, t0 + timeout - 45)
    if rc not in (0,):
        print(f"[bench] device child ended with {rc}", file=sys.stderr)
    if result is not None:
        obj = json.loads(result)
        obj["detail"]["card"] = card_name_and_power_limit()
        print(json.dumps(obj))
        return
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": 0.0,
                "unit": "symbols/s/chip",
                "vs_baseline": 0.0,
                "error": f"no result within {timeout:.0f}s (last status: {rc})",
            }
        )
    )


if __name__ == "__main__":
    if os.environ.get("ROPEBWT2_TPU_BENCH_INNER") == "1":
        inner()
    else:
        main()
