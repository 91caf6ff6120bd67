"""Map-growth stress run: hundreds of keyframes through the LIVE system.

Exercises the paths that only engage at scale (SURVEY.md §5.7's map-growth
axis): the pose graph's automatic dense-Cholesky -> matrix-free-CG switch
(PoseGraphConfig.cg_vertex_threshold), BoW retrieval over a few hundred
keyframes, landmark-budget saturation, and repeated loop closures over a
3-revolution tour of the multi-room world.

Every power-of-two budget doubling (KF store / device bank / edge slots /
landmark table) recompiles the device programs sized by that budget —
seconds each at deployment size. The run therefore instruments jax's compile events
(/jax/core/compile/backend_compile_duration) and reports, per fps window,
how many compiles fired and how many seconds they cost, so the growth stall
is measured rather than guessed. `--prealloc` applies the mitigation:
pre-bucket every budget to the expected tour size so ALL compiles happen at
startup (and land in the persistent compile cache, making subsequent runs
free)
and the steady-state loop never stalls.

  python benchmarks/scale_run.py [--frames 360] [--loops 3] [--platform cpu]
      [--batch 8] [--prealloc] [--window 60]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=360)
    ap.add_argument("--loops", type=float, default=3.0)
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    ap.add_argument("--batch", type=int, default=0,
                    help="use track_batch with this B (0 = per-frame)")
    ap.add_argument("--prealloc", action="store_true",
                    help="pre-bucket KF/edge/landmark budgets to the "
                    "expected tour size (no mid-run doubling recompiles)")
    ap.add_argument("--window", type=int, default=60,
                    help="frames per fps/compile accounting window")
    args = ap.parse_args()

    import jax

    from rgbdslam.utils.compile_cache import enable_compile_cache

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    # compile accounting: every backend compile (trace/lower excluded)
    # bumps the counter
    compile_stats = {"n": 0, "s": 0.0}
    from jax._src import monitoring as _mon

    def _on_event(name, dur, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            compile_stats["n"] += 1
            compile_stats["s"] += dur

    _mon.register_event_duration_secs_listener(_on_event)

    import numpy as np

    import rgbdslam  # noqa: F401
    from rgbdslam.config import (ExtractorConfig, KeyframeConfig,
                                 LoopConfig, PoseGraphConfig, SlamConfig)
    from rgbdslam.eval.ate import ate_rmse
    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.slam.system import SlamSystem

    cam = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
    n = args.frames

    kf_kw, pg_kw, lm_kw = {}, {}, {}
    if args.prealloc:
        # pre-bucket to the expected tour: on this synthetic tour nearly
        # every frame passes the 0.20 m / 10 deg KF gate (840 frames -> 770
        # KFs measured), edges run ~7x KFs and landmarks ~140x KFs, so one
        # power-of-two bucket above those covers the run with zero mid-run
        # doublings
        p2 = lambda x: 1 << max(9, int(x - 1).bit_length())  # noqa: E731
        kf_kw = {"max_keyframes": p2(n)}
        pg_kw = {"max_edges": p2(8 * n)}
        lm_kw = {"max_landmarks": p2(150 * n)}
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=384, num_levels=3, cell_size=6,
                                  fast_threshold=12.0, min_response=8.0,
                                  min_border=16),
        loop=LoopConfig(id_interval=40, min_kfs_since_loop=15,
                        vocab_size=1024),
        keyframe=KeyframeConfig(**kf_kw),
        pose_graph=PoseGraphConfig(**pg_kw),
        **lm_kw,
    )
    ds = SyntheticDataset(n_frames=n, cam=cam, trajectory="tour",
                          loops=args.loops)
    system = SlamSystem(cam, cfg, seed=0)

    W = max(1, args.window)
    windows = []  # per-window dicts: fps, compiles, compile_s
    w_t0 = time.perf_counter()
    w_n0, w_s0 = compile_stats["n"], compile_stats["s"]

    def _window_close(frames_done):
        nonlocal w_t0, w_n0, w_s0
        dt = time.perf_counter() - w_t0
        windows.append({
            "frames": frames_done,
            "fps": round(W / dt, 2),
            "compiles": compile_stats["n"] - w_n0,
            "compile_s": round(compile_stats["s"] - w_s0, 2),
            "kfs": system.store.count,
        })
        print(f"frame {frames_done}/{n}  KFs={system.store.count} "
              f"edges={system.graph.n_edges} loops={system.loops_closed} "
              f"win_fps={windows[-1]['fps']} "
              f"win_compiles={windows[-1]['compiles']} "
              f"({windows[-1]['compile_s']} s)", file=sys.stderr)
        w_t0 = time.perf_counter()
        w_n0, w_s0 = compile_stats["n"], compile_stats["s"]

    t0 = time.perf_counter()
    if args.batch:
        B = args.batch
        frames = [ds.grab(i) for i in range(n)]
        for i in range(0, n, B):
            c = frames[i:i + B]
            system.track_batch([x[0] for x in c], [x[1] for x in c],
                               [x[2] for x in c])
            if (i + B) % W < B:
                _window_close(min(i + B, n))
    else:
        for i in range(n):
            ts, gray, depth = ds.grab(i)
            system.track(ts, gray, depth)
            if (i + 1) % W == 0:
                _window_close(i + 1)
    system.finish()
    wall = time.perf_counter() - t0

    ts_c, poses_c = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
    from rgbdslam.solvers.pose_graph import PoseGraph

    Kp = PoseGraph._pad(system.graph.n_vertices)
    print(json.dumps({
        "metric": "scale_run",
        "frames": n,
        "loops_toured": args.loops,
        "keyframes": system.store.count,
        "graph_edges": system.graph.n_edges,
        "loops_closed": system.loops_closed,
        "landmarks": int(system.landmarks.count),
        "solver_path": "cg" if Kp >= cfg.pose_graph.cg_vertex_threshold
        else "dense",
        "ate_rmse": round(float(rmse), 4),
        "fps": round(n / wall, 2),
        "failures": system.tracker.stats.failures,
        "prealloc": bool(args.prealloc),
        "compiles_total": compile_stats["n"],
        "compile_s_total": round(compile_stats["s"], 2),
        "windows": windows,
    }))


if __name__ == "__main__":
    main()
