"""Two-process jax.distributed CPU test (SURVEY §5).

Spawns tests/multihost_worker.py twice with coordinator env variables;
each process owns 2 virtual CPU devices, forming a fake 2-host, 4-device
mesh.  The worker validates initialize_from_env, local_shard_range, the
multi-controller sharded averaging, and a psum'd replicated-parameter
gradient.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": root,
        })
        # The test session's own XLA_FLAGS (8 virtual devices) must not
        # leak into the workers, which configure 2 devices each
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST OK pid={pid}" in out, out
