"""Time the flat-tier merge and the pending merge on the GPU.

    python scripts/measure_merge.py [--ab-batches N] [--out FILE]

1. The merge alone at the golden build's shapes (cap 2^30, K=128): the
   GPU kernel (index/merge_gpu.py) against the plain XLA merge
   (apply_insertions + build_block_tables), for one round's 2^18
   insertions and for a deferred flush of defer_r * 2^18, each checked
   byte-equal on the live prefix.
2. pending_add at the flush's pending capacity: with the flush times this
   gives engine/bcr.py's FLUSH_PER_PEND_KERNEL and FLUSH_PER_PEND_PLAIN =
   (flush s per capacity symbol) / (pending_add s per pending row), the
   constants of TpuBwt's auto defer depth.
3. The first N batches of the golden build (tests/golden_md5.json,
   "scale_r05") with the kernel and with the plain merge, each at its auto
   defer depth and at depth 16 (32 where the auto depth is 16), in one
   process, batch walls synced per batch.  With N = 40 (the whole build)
   the md5 is checked too.

Needs the GPU; prints one JSON summary line last and writes it to --out.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def timed(fn, *args, reps=5):
    """(median s, min s, output) of fn(*args) over reps synced calls after
    one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts)), out


def merge_alone(cap, n, m, K=128):
    import jax
    import jax.numpy as jnp

    from ropebwt2_tpu.index.merge import apply_insertions
    from ropebwt2_tpu.index.merge_gpu import merge_flat
    from ropebwt2_tpu.index.rank import build_block_tables

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    bwt = jax.random.randint(k1, (cap,), 0, 6, jnp.int8)
    pos = jnp.sort(jax.random.randint(k2, (m,), 0, n + 1, jnp.int32))
    sym = jax.random.randint(k3, (m,), 0, 6, jnp.int32)
    stream = jnp.arange(m, dtype=jnp.int32)
    valid = jnp.ones(m, bool)
    nn = jnp.asarray(n, jnp.int64)
    args = (bwt, nn, pos, sym, stream, valid)

    @jax.jit
    def plain(bwt, n, pos, sym, stream, valid):
        out = apply_insertions(bwt, n, pos, sym, stream, valid)
        return out, build_block_tables(out, K, dtype=jnp.int32)

    kern = jax.jit(lambda *a: merge_flat(*a, K=K, dtype=jnp.int32))
    tp, tp_min, (ob, ot) = timed(plain, *args)
    res = {"cap": cap, "n": n, "m": m, "plain_s": tp, "plain_min_s": tp_min}
    try:
        tk, tk_min, (kb, kt) = timed(kern, *args)
    except Exception as e:  # the kernel's compile is the unknown here
        res["kernel_error"] = f"{type(e).__name__}: {str(e)[:2000]}"
        return res
    live = n + m
    same = bool(jnp.array_equal(ob[:live], kb[:live])) and bool(
        jnp.array_equal(ot[: live // K + 1], kt[: live // K + 1]))
    res.update(kernel_s=tk, kernel_min_s=tk_min, equal=same)
    return res


def pending_alone(pcap, m, fill):
    import jax
    import jax.numpy as jnp

    from ropebwt2_tpu.index.pending import (
        KP, PendingIndex, _inf, pending_add,
    )
    from ropebwt2_tpu.index.rank import build_block_tables

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    span = 1 << 29
    vp = jnp.sort(jax.random.randint(k1, (fill,), 0, span - fill, jnp.int32))
    vp = jnp.concatenate([vp + jnp.arange(fill, dtype=jnp.int32),  # unique
                          jnp.full((pcap - fill,), _inf(jnp.int32))])
    psym = jnp.concatenate([
        jax.random.randint(k2, (fill,), 0, 6, jnp.int8),
        jnp.full((pcap - fill,), 6, jnp.int8)])
    pend = PendingIndex(vp=vp, psym=psym,
                        blk_prefix=build_block_tables(psym, KP, jnp.int32),
                        p=jnp.asarray(fill, jnp.int32))
    gX = jnp.sort(jax.random.randint(k3, (m,), 0, span, jnp.int32))
    sym = jnp.zeros(m, jnp.int32)
    stream = jnp.arange(m, dtype=jnp.int32)
    active = jnp.ones(m, bool)
    t, t_min, _ = timed(jax.jit(pending_add), pend, gX, sym, stream, active)
    return {"pcap": pcap, "m": m, "fill": fill, "pending_add_s": t,
            "pending_add_min_s": t_min}


def golden_prefix(nbatch, use_kernel, defer_r=None):
    """Batch walls of the first nbatch golden batches (defer_r None: the
    auto depth); the md5 when the whole build ran."""
    import jax

    import chip_smoke
    import readgen
    from ropebwt2_tpu.engine import TpuBwt
    from ropebwt2_tpu.engine import bcr

    jax.clear_caches()
    keep = bcr.merge_kernel_applies
    if not use_kernel:
        bcr.merge_kernel_applies = lambda *a: False
    try:
        g = json.load(open(chip_smoke.GOLDEN))["builds"]["scale_r05"]
        mb = g["mbatch"]
        gen = readgen.ReadGen(seed=g["seed"], nreads=g["nreads"], L=g["L"],
                              mode=g["mode"], cov=g["cov"], err=g["err"])
        eng = TpuBwt(so=g["so"], defer_r=defer_r)
        eng._plan(g["symbols"])
        defer = eng._choose_defer(mb)
        walls = []
        for _ in range(nbatch):
            reads = gen.batch(mb).view(np.int8)
            t0 = time.perf_counter()
            eng.insert_multi(reads)
            jax.block_until_ready(eng.state)
            walls.append(time.perf_counter() - t0)
        res = {"kernel": use_kernel, "defer_r": defer[0], "pcap": defer[1],
               "first_s": walls[0], "steady_s": walls[1:],
               "steady_sum_s": float(sum(walls[1:]))}
        if nbatch * mb == g["nreads"]:
            if g["phantom_empty_read"]:
                eng.insert_multi([np.zeros(0, np.int8)])
            res["md5_ok"] = chip_smoke.text_md5(eng.bwt_array()) == g["md5"]
        del eng
        return res
    finally:
        bcr.merge_kernel_applies = keep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab-batches", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "measure_merge.json"))
    args = ap.parse_args()
    import subprocess

    import jax

    import ropebwt2_tpu  # noqa: F401
    from ropebwt2_tpu.index.pending import pending_cap

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"measure_merge: no GPU (JAX found {dev})\n")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"[card] {card}", flush=True)
    cap, mb, R = 1 << 30, 1 << 18, 16
    out = {"card": card, "device_kind": dev.device_kind}
    out["round"] = merge_alone(cap, cap // 2, mb)
    print(f"[merge] round {out['round']}", flush=True)
    pcap = pending_cap(mb, R)
    out["flush"] = merge_alone(cap, cap // 2, pcap)
    print(f"[merge] flush {out['flush']}", flush=True)
    out["pending"] = pending_alone(pcap, mb, pcap - mb)
    print(f"[pending] {out['pending']}", flush=True)
    c_pend = out["pending"]["pending_add_s"] / pcap
    for impl in ("plain", "kernel"):
        if f"{impl}_s" in out["flush"]:
            out[f"flush_per_pend_{impl}"] = (
                out["flush"][f"{impl}_s"] / cap) / c_pend
    print(f"[ratio] {({k: v for k, v in out.items() if 'per_pend' in k})}",
          flush=True)
    if args.ab_batches:
        ab = []
        for use_kernel in (True, False):
            if use_kernel and "kernel_s" not in out["flush"]:
                continue
            r = golden_prefix(args.ab_batches, use_kernel)
            print(f"[golden-ab] {r}", flush=True)
            ab.append(r)
            other = 16 if r["defer_r"] != 16 else 32
            r = golden_prefix(args.ab_batches, use_kernel, other)
            print(f"[golden-ab] {r}", flush=True)
            ab.append(r)
        out["golden_ab"] = ab
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
