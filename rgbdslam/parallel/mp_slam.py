"""Live multi-PROCESS SLAM: tracking process + backend peer processes.

The reference's backend is a live concurrent consumer of the tracker's
keyframes across a THREAD boundary (Solver/PoseGraph.cpp:59-103,289-302: the
PoseGraph thread polls a mutex-guarded queue every 3 ms). This module is the
multi-host equivalent (SURVEY.md §2.7 P7): the boundary is an OS-process /
DCN boundary instead —

  * process 0 runs the full SlamSystem (tracking, keyframes, loop detection)
    and PUBLISHES every pose-graph mutation — vertices, odometry/proximity/
    loop edges, solve announcements — over the asynchronous TCP constraint
    channel (multihost.ConstraintExchange; publish() never blocks on the
    consumer, exactly like the reference's queue insert),
  * backend peer processes hold an identical PoseGraph mirror built from the
    received records and JOIN every solve: each solve is the edge-sharded
    shard_map CG-LM program (parallel/dist_ba.py) over the GLOBAL device
    mesh (jax.distributed multi-controller), so the Gauss-Newton reductions
    ride collectives across every process's devices — ICI within a host,
    DCN across real hosts.

Determinism contract: the peers' mirrors must hold bit-identical vertex/edge
arrays when a solve starts (each process contributes its addressable shards
of the same global value). This holds because (a) the channel is one TCP
connection per peer → records apply in publish order, (b) a solve is
announced AFTER every mutation it depends on, and (c) between solves the
only writer of graph state is process 0 (solve write-backs are replicated
collective outputs, identical everywhere). Local/global BA must be OFF in
this mode — they mutate poses outside the mirrored channel (asserted below).

Record encoding over the fixed 80-byte ConstraintExchange wire format
[sender i32 | a i32 | b i32 | weight f32 | Z 16xf32]:

  EDGE    a,b >= 0   Z = measurement T_{a<-b}; the provenance kind
                     (1 odometry / 2 proximity / 3 loop) rides Z[3,0] —
                     an SE(3) matrix's bottom row is [0,0,0,1], so the
                     lane is free and the wire format stays unchanged
  VERTEX  a = -2     b = vertex id, Z = Twc at creation
  SOLVE   a = -3     b = iterations, weight = n_edges, Z[0,0] = n_vertices
  DONE    a = -4     run over; peers drain and exit

Run as a module, this file is the per-process worker used by
tests/test_mp_slam.py:

  python -m rgbdslam.parallel.mp_slam \
      --coordinator localhost:9755 --num-processes 2 --process-id $i \
      --devices-per-process 4 --exchange-base-port 9800 --frames 80
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from rgbdslam.parallel.multihost import (ConstraintExchange, global_mesh,
                                         initialize)

_VERTEX, _SOLVE, _DONE = -2, -3, -4


def attach_publisher(graph, ex: ConstraintExchange) -> None:
    """Wire a PoseGraph's mutation hooks to the constraint channel
    (process 0 side)."""

    def on_vertex(k: int, Twc: np.ndarray):
        ex.publish(_VERTEX, k, Twc, 0.0)

    def on_edge(a: int, b: int, Z: np.ndarray, w: float, kind: int):
        Zk = np.asarray(Z, np.float32).copy()
        Zk[3, 0] = float(kind)
        ex.publish(a, b, Zk, w)

    def on_solve(iterations: int, n_vertices: int, n_edges: int):
        Zs = np.zeros((4, 4), np.float32)
        Zs[0, 0] = float(n_vertices)
        ex.publish(_SOLVE, iterations, Zs, float(n_edges))

    graph.on_vertex = on_vertex
    graph.on_edge = on_edge
    graph.on_solve = on_solve


def run_backend_peer(graph, ex: ConstraintExchange,
                     poll_s: float = 0.002, timeout_s: float = 600.0) -> dict:
    """Backend peer drive loop: apply records in order, join every solve.

    The reference analog is PoseGraph::run's 3 ms poll of the keyframe queue
    (Solver/PoseGraph.cpp:99); here the queue is the DCN channel and the
    'consume' step of a solve announcement is joining the collective."""
    stats = {"vertices": 0, "edges_odometry": 0, "edges_proximity": 0,
             "edges_loop": 0, "solves_joined": 0}
    kind_key = {1: "edges_odometry", 2: "edges_proximity", 3: "edges_loop"}
    deadline = time.time() + timeout_s
    done = False
    while not done:
        recs = ex.poll()
        if not recs:
            if time.time() > deadline:
                raise TimeoutError("backend peer: no DONE before timeout")
            time.sleep(poll_s)
            continue
        for (_snd, a, b, Z, w) in recs:
            if a == _VERTEX:
                k = graph.add_vertex(Z)
                assert k == b, f"vertex mirror skew: got {k}, expected {b}"
                stats["vertices"] += 1
            elif a == _SOLVE:
                n_v, n_e = int(round(Z[0, 0])), int(round(w))
                assert graph.n_vertices == n_v and graph.n_edges == n_e, (
                    f"mirror skew at solve: have ({graph.n_vertices} v, "
                    f"{graph.n_edges} e), announced ({n_v}, {n_e})")
                graph.optimize(int(b))
                stats["solves_joined"] += 1
            elif a == _DONE:
                done = True
            else:
                kind = int(round(Z[3, 0]))
                Zc = np.asarray(Z, np.float32).copy()
                Zc[3, 0] = 0.0
                graph.add_edge(int(a), int(b), Zc, weight=float(w),
                               kind=kind)
                stats[kind_key.get(kind, "edges_proximity")] += 1
    return stats


def _make_config():
    """The run configuration — IDENTICAL on every process (the peer builds
    its PoseGraph mirror from it). Matches tests/test_distributed_system.py's
    operating point so the 2-process trajectory is directly comparable to
    the single-process runs."""
    from rgbdslam.config import ExtractorConfig, LoopConfig, SlamConfig

    return SlamConfig(
        extractor=ExtractorConfig(num_features=1024, num_levels=3,
                                  cell_size=8, fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10,
                        vocab_size=256),
        distributed=True,
    )


def _make_graph_mirror(cfg, mesh):
    """Peer-side PoseGraph with construction parameters identical to
    SlamSystem.__init__'s (slam/system.py) — required for identical padded
    solve shapes and static solver arguments."""
    from rgbdslam.solvers.pose_graph import PoseGraph

    g = PoseGraph(
        cfg.keyframe.max_keyframes,
        cfg.pose_graph.max_edges,
        information=cfg.pose_graph.edge_information,
        huber_delta=cfg.pose_graph.huber_delta,
        cg_threshold=cfg.pose_graph.cg_vertex_threshold,
        cg_iters=cfg.pose_graph.cg_iters,
        lm_lambda0=cfg.pose_graph.lm_lambda0,
    )
    g.mesh = mesh
    return g


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:9755")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--exchange-base-port", type=int, required=True)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--out", default=None,
                    help="process 0: write the camera trajectory npz here")
    args = ap.parse_args(argv)
    pid, nproc = args.process_id, args.num_processes

    # the constraint channel binds BEFORE jax.distributed.initialize — the
    # distributed rendezvous then doubles as the "all listeners up" barrier,
    # so no publish can race a peer's bind
    ex = ConstraintExchange(
        args.exchange_base_port + pid,
        [f"localhost:{args.exchange_base_port + p}"
         for p in range(nproc) if p != pid],
        sender=pid,
    )
    jax = initialize(args.coordinator, nproc, pid, platform=args.platform,
                     devices_per_process=args.devices_per_process)
    assert jax.process_count() == nproc
    mesh = global_mesh()

    cfg = _make_config()
    result = {"process_id": pid, "processes": nproc,
              "global_devices": jax.device_count()}

    if pid == 0:
        from rgbdslam.eval.ate import ate_rmse
        from rgbdslam.geometry.camera import Camera
        from rgbdslam.io.synthetic import SyntheticDataset
        from rgbdslam.slam.system import SlamSystem

        # local/global BA mutate keyframe poses outside the mirrored
        # channel — the multi-process contract forbids them (docstring)
        assert not cfg.use_local_ba and not cfg.use_global_ba, (
            "multi-process SLAM requires pose-graph-only backend")
        cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
        n = args.frames
        ds = SyntheticDataset(n_frames=n, cam=cam, trajectory="orbit",
                              loops=1.15)
        system = SlamSystem(cam, cfg, seed=0)
        # the distributed flag already routed every solve over the GLOBAL
        # mesh (jax.devices() spans all processes after initialize)
        assert system._mesh is not None
        assert system._mesh.size == jax.device_count()
        attach_publisher(system.graph, ex)

        t0 = time.perf_counter()
        for i in range(n):
            ts, gray, depth = ds.grab(i)
            system.track(ts, gray, depth)
        system.finish()
        wall = time.perf_counter() - t0
        # warm system-level solve rate: re-run the final solve with the
        # shard_map program now compiled (the cold loop_solve_ms is
        # dominated by the one-time compile on CPU hosts); the peers join
        # it like any other announced solve
        t0 = time.perf_counter()
        system.graph.optimize(cfg.pose_graph.opt_iters_default)
        warm_s = time.perf_counter() - t0
        ex.publish(_DONE, 0, np.eye(4, dtype=np.float32), 0.0)

        ts_c, poses_c = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps[:n],
                           ds.poses_twc[:n])
        result.update(
            frames=n,
            fps=round(n / wall, 2),
            keyframes=system.store.count,
            loops_closed=system.loops_closed,
            graph_edges=system.graph.n_edges,
            dist_solves=system.graph.dist_solves,
            loop_solve_ms=system.loop_solve_ms,
            solve_gn_iters_per_s=[
                round(cfg.pose_graph.opt_iters_loop / (ms / 1e3), 1)
                for ms in system.loop_solve_ms],
            warm_solve_ms=round(warm_s * 1e3, 1),
            warm_gn_iters_per_s=round(
                cfg.pose_graph.opt_iters_default / warm_s, 1),
            ate_rmse=round(float(rmse), 5),
        )
        if args.out:
            np.savez(args.out, timestamps=ts_c, poses_twc=poses_c)
    else:
        graph = _make_graph_mirror(cfg, mesh)
        stats = run_backend_peer(graph, ex)
        result.update(stats)
        result["dist_solves"] = graph.dist_solves

    ex.close()
    print(json.dumps(result))
    sys.stdout.flush()
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
