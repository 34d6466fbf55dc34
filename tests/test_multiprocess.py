"""TRUE multi-process (multi-controller) simulation: two OS processes,
each owning 4 CPU devices, federate via jax.distributed into one 2x4
(host, shard) mesh and run the sharded BCR batch program across process
boundaries — the CPU stand-in for a multi-host cluster (SURVEY.md §7.7).
Each process asserts byte parity of its own shards (scripts/mp_sim.py)."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multiprocess_sharded_batch():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", JAX_NUM_CPU_DEVICES="4")
    env.pop("XLA_FLAGS", None)  # device count comes from JAX_NUM_CPU_DEVICES
    script = os.path.join(REPO, "scripts", "mp_sim.py")
    p0 = subprocess.Popen(
        [sys.executable, script, "0", port], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    p1 = subprocess.Popen(
        [sys.executable, script, "1", port], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    out0, _ = p0.communicate(timeout=600)
    out1, _ = p1.communicate(timeout=600)
    assert p0.returncode == 0, out0.decode()[-3000:]
    assert p1.returncode == 0, out1.decode()[-3000:]
    assert b"MPSIM OK 0" in out0
    assert b"MPSIM OK 1" in out1
