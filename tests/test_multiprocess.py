"""Multi-PROCESS distributed pose-graph optimization (SURVEY.md §4, §2.7 P7).

Launches N real OS processes, each with its own JAX runtime and 4 virtual CPU
devices, joined through `jax.distributed.initialize` (gloo collectives). The
edge-sharded matrix-free-CG Gauss-Newton then runs over the 2x4=8-device
*global* mesh — the same program a multi-host GPU job runs over NVLink and the network — and
every process checks the result against its local single-device dense solve.

This is the process-boundary test the reference cannot have (it is a
single-process system; its backend solve is /root/reference/Solver/
PoseGraph.cpp:350-368).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(num_processes: int, port: int, extra=()):
    """Start all worker processes; return the Popen list."""
    procs = []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # workers pin their own device count
    env.pop("JAX_PLATFORMS", None)
    env["JAX_TRACEBACK_FILTERING"] = "off"
    for pid in range(num_processes):
        cmd = [
            sys.executable, "-m", "rgbdslam.parallel.multihost",
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(num_processes),
            "--process-id", str(pid),
            "--devices-per-process", "4",
            "--vertices", "48", "--edges", "192",
            "--iterations", "6", "--cg-iters", "48",
            "--check", *extra,
        ]
        procs.append(
            subprocess.Popen(
                cmd, cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    return procs


@pytest.mark.slow
def test_two_process_distributed_pose_graph():
    port = _free_port()
    procs = _launch(2, port)
    results = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        results.append(json.loads(line))

    assert results[0]["global_devices"] == 8
    assert results[0]["processes"] == 2
    for r in results:
        # distributed CG result matches each process's local dense solve
        assert r["check_ok"], r
        assert r["max_diff_vs_dense"] < 5e-3
        # and recovers the ground-truth poses (noise-free measurements)
        assert r["max_translation_err"] < 5e-3


@pytest.mark.slow
def test_two_process_async_constraint_exchange():
    """Loop constraints discovered on one host reach the others over the
    asynchronous DCN channel (TCP, no collective/barrier) BEFORE the solve:
    each process withholds one loop edge, publishes it, merges the peers'
    edges, and the distributed solve must still match the full-edge-set
    dense solve (SURVEY.md §2.7 P7's 'loop-closure constraints exchanged
    over DCN asynchronously')."""
    port = _free_port()
    ex_port = _free_port()
    procs = _launch(2, port,
                    extra=("--exchange-base-port", str(ex_port)))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        results.append(json.loads(line))
    for r in results:
        assert r["exchanged_constraints"] == 1, r
        assert r["check_ok"], r
