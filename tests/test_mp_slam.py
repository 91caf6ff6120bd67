"""Live SLAM across 2 OS processes (VERDICT r4 item 1; SURVEY.md §2.7 P7).

The reference's backend is a live concurrent consumer of the tracker's
keyframes across a thread boundary (/root/reference/Solver/PoseGraph.cpp:
59-103,289-302). Here the boundary is an OS-process boundary: process 0
runs the full SlamSystem and publishes every graph mutation over the
asynchronous TCP constraint channel; process 1 is a backend peer holding a
live mirror that JOINS every solve over the 2x4=8-device global mesh
(jax.distributed, gloo collectives). Asserted:

  1. the peer's mirror consumed the complete live graph — vertex-for-vertex,
     edge-for-edge — including at least one LOOP constraint delivered across
     the socket,
  2. every solve (mid-run loop closure + shutdown final) ran as a
     cross-process collective on both sides,
  3. the 2-process trajectory matches a single-process run of the same
     sequence to < 5 cm (the solvers differ only by dense Cholesky vs
     distributed CG).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 80


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_live_slam(tmp_path):
    port, ex_port = _free_port(), _free_port()
    traj_out = str(tmp_path / "traj.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)       # workers pin their own device count
    env.pop("JAX_PLATFORMS", None)
    env["JAX_TRACEBACK_FILTERING"] = "off"
    procs = []
    for pid in range(2):
        cmd = [
            sys.executable, "-m", "rgbdslam.parallel.mp_slam",
            "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--process-id", str(pid),
            "--devices-per-process", "4",
            "--exchange-base-port", str(ex_port),
            "--frames", str(FRAMES),
        ]
        if pid == 0:
            cmd += ["--out", traj_out]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = {}
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, f"process {pid} failed:\n{err[-4000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        results[pid] = json.loads(line)

    r0, r1 = results[0], results[1]
    # full SLAM ran on the global mesh and closed the loop
    assert r0["global_devices"] == 8
    assert r0["loops_closed"] >= 1
    assert r0["dist_solves"] >= 2, r0      # mid-run loop solve + final
    assert r0["ate_rmse"] < 0.10, r0

    # the backend peer consumed the COMPLETE live graph across the socket
    assert r1["vertices"] == r0["keyframes"], (r0, r1)
    n_peer_edges = (r1["edges_odometry"] + r1["edges_proximity"]
                    + r1["edges_loop"])
    assert n_peer_edges == r0["graph_edges"], (r0, r1)
    # >=1 loop-closure constraint demonstrably delivered over the async
    # DCN channel (SURVEY §2.7 P7)
    assert r1["edges_loop"] >= 1, r1
    # every solve was a cross-process collective, joined on both sides
    assert r1["solves_joined"] == r0["dist_solves"], (r0, r1)
    assert r1["dist_solves"] == r0["dist_solves"]

    # trajectory parity: single-process run of the same sequence (dense
    # Cholesky solves) vs the 2-process distributed-CG run
    from rgbdslam.eval.ate import ate_rmse
    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.parallel.mp_slam import _make_config
    from rgbdslam.slam.system import SlamSystem

    cfg = dataclasses.replace(_make_config(), distributed=False)
    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    ds = SyntheticDataset(n_frames=FRAMES, cam=cam, trajectory="orbit",
                          loops=1.15)
    system = SlamSystem(cam, cfg, seed=0)
    for i in range(FRAMES):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()
    ts_s, poses_s = system.camera_trajectory()
    rmse_s, _ = ate_rmse(ts_s, poses_s, ds.timestamps[:FRAMES],
                         ds.poses_twc[:FRAMES])
    assert rmse_s < 0.10

    mp = np.load(traj_out)
    poses_mp = mp["poses_twc"]
    assert poses_mp.shape == poses_s.shape
    diff = np.linalg.norm(poses_mp[:, :3, 3] - poses_s[:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.05, (
        f"2-process vs single-process divergence {diff.max():.3f} m")
