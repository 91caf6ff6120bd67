"""Benchmark: end-to-end tracking + full-SLAM frames/s on one GPU.

Prints ONE JSON line on stdout (everything else goes to stderr):
  {"metric": "tracking_fps_1chip", "value": N, "unit": "frames/s",
   "vs_baseline": N, "full_slam_fps_1chip": N, ...,
   "cpu_fps_measured_this_host": N}

Two measurements:
- `tracking_fps_1chip` (the headline `value`): the per-frame hot path
  (SURVEY.md §3.1-3.2) — feature extraction (pyramid + FAST/Shi-Tomasi +
  BRIEF-256), 1024x1024 256-bit Hamming 2-NN matching, batched RANSAC SE3
  with the GICP polish — at the reference's native 640x480 / 1024-feature
  budget, as the B=8 scan of slam/pipeline.PipelinedOdometry.
- `full_slam_fps_1chip`: the complete SlamSystem over the multi-room tour —
  keyframe creation, batched proximity verification, BoW loop detection +
  closure, pose-graph solves, landmark bookkeeping.

Baseline: the reference publishes no frames/s (BASELINE.md); the C++ stack
(libfast + OpenCV BRIEF + BFMatcher + PCL RANSAC) at these settings is a
~30 fps-class CPU workload (it displayed mean track time live in its viewer
HUD, Drawer/Viewer.cpp:54,118). vs_baseline is measured fps / 30;
`cpu_fps_measured_this_host` runs the single-step tracking path on this
host's CPU backend, in a subprocess that never opens the GPU.

The bench needs a GPU and fails without one; no phase's failure is caught.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 30.0


def cpu_anchor_worker():
    """Measure the single-step tracking path on the CPU backend (subprocess
    mode: `python bench.py --cpu-anchor-worker`). Prints one float (fps).
    The parent starts it with JAX_PLATFORMS=cpu, so it never opens the
    GPU that the parent holds."""
    import jax

    if jax.default_backend() != "cpu":
        raise RuntimeError("the CPU anchor must run on the CPU backend")

    from rgbdslam.config import SlamConfig
    from rgbdslam.frontend.frame import build_frame_features
    from rgbdslam.frontend.matcher import (gather_matched_points,
                                           match_frames)
    from rgbdslam.geometry.camera import SYNTHETIC
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.solvers.ransac_se3 import ransac_se3

    cfg = SlamConfig()
    cam = SYNTHETIC
    ds = SyntheticDataset(n_frames=4, cam=cam, trajectory="sweep")
    frames = [ds.grab(i)[1:] for i in range(len(ds))]

    def tracking_step(f_ref, gray_cur, depth_cur, key):
        f_cur = build_frame_features(cam, gray_cur, depth_cur, cfg.extractor)
        m = match_frames(f_ref, f_cur, cfg.matcher.nn_ratio)
        p1, p2, w, valid = gather_matched_points(f_ref, f_cur, m)
        res = ransac_se3(p1, p2, w, valid, key, cfg.ransac)
        return f_cur, res.T21

    step = jax.jit(tracking_step)
    key = jax.random.PRNGKey(0)
    feats = build_frame_features(cam, *frames[0], cfg.extractor)
    out = step(feats, *frames[1], key)
    jax.block_until_ready(out)
    n = 6
    t0 = time.perf_counter()
    f_c = feats
    for i in range(n):
        key, sub = jax.random.split(key)
        f_c, T = step(f_c, *frames[(i + 1) % len(frames)], sub)
    jax.block_until_ready(T)
    print(n / (time.perf_counter() - t0))


def measure_cpu_anchor() -> float:
    """Run the CPU anchor in a subprocess restricted to the CPU backend."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cpu-anchor-worker"],
        capture_output=True, text=True, timeout=600, check=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    return float(out.stdout.strip().splitlines()[-1])


def measure_full_slam(n_frames: int = 128) -> dict:
    """Wall-clock fps of the complete SlamSystem (keyframes + proximity +
    BoW loop detection + closure + graph solves) on the multi-room tour —
    the figure-eight revisits the start beyond the 0.5 m proximity radius,
    so the mid-run optimize(20) loop-closure path
    (Solver/PoseGraph.cpp:71,350-368) runs in the timed region.

    The shipped vocabulary is loaded at startup (the reference's
    voc_TUM_FAST_BRIEF workflow, main.cpp:15,32). Per-frame and
    double-buffered batched modes (B=8, B=32) are measured, each with its
    host<->device budget (dispatches + fetches per frame, host wall blocked
    on fetches).

    One warm-up pass compiles every program shape (persistent-cached); the
    timed passes use fresh systems so per-frame work is identical."""
    import jax

    from rgbdslam.config import LoopConfig, SlamConfig
    from rgbdslam.geometry.camera import SYNTHETIC
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.loop.vocabulary import shipped_vocabulary
    from rgbdslam.slam.system import SlamSystem
    from rgbdslam.utils.rpccount import RPC

    cfg = SlamConfig(loop=LoopConfig(id_interval=12, min_kfs_since_loop=10))
    cam = SYNTHETIC
    ds = SyntheticDataset(n_frames=n_frames, cam=cam, trajectory="tour")
    frames = []
    for i in range(n_frames):
        ts, gray, depth = ds.grab(i)
        frames.append((ts, gray, depth))
    jax.block_until_ready(frames[-1][1])
    voc = shipped_vocabulary("svo_fast")

    def run(batch=0):
        system = SlamSystem(cam, cfg, seed=0)
        if voc:
            system.load_vocabulary(voc)
        if batch == "ring":
            # per-frame deployment shape with the depth-2 dispatch/fetch
            # ring: ONE blocking fetch per frame (the keyframe blob rides
            # the next frame's fetch)
            for ts, gray, depth in frames:
                system.track_pipelined(ts, gray, depth)
            system.track_pipelined_flush()
        elif batch == 0:
            for ts, gray, depth in frames:
                system.track(ts, gray, depth)
        else:
            # double-buffered: dispatch batch i+1 BEFORE completing batch i
            pending = None
            for i in range(0, n_frames, batch):
                c = frames[i:i + batch]
                h = system.track_batch_dispatch(
                    [x[0] for x in c], [x[1] for x in c], [x[2] for x in c])
                if pending is not None:
                    system.track_batch_complete(pending)
                pending = h
            if pending is not None:
                system.track_batch_complete(pending)
        system.finish()
        return system

    from rgbdslam.eval.ate import ate_rmse

    def timed(batch, label: str):
        t0 = time.perf_counter()
        run(batch)             # warm-up: compiles (persistent-cached)
        print(f"{label} warmup: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
        RPC.reset()
        t0 = time.perf_counter()
        system = run(batch)
        dt = time.perf_counter() - t0
        ts_c, poses_c = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps[:n_frames],
                           ds.poses_twc[:n_frames])
        stats = {
            "fps": round(n_frames / dt, 2),
            "wall_s": round(dt, 2),
            "rpcs_per_frame": round(RPC.total / n_frames, 2),
            "fetch_wait_s": round(RPC.fetch_s, 2),
            "host_busy_s": round(dt - RPC.fetch_s, 2),
            "keyframes": system.store.count,
            "loops_closed": system.loops_closed,
            "loop_solve_ms": system.loop_solve_ms,
            "rpc_count": RPC.total,
            "ate_m": round(float(rmse), 4),
        }
        print(f"{label}: {stats['fps']} fps, {stats['rpcs_per_frame']} "
              f"RPCs/frame, {stats['loops_closed']} loops "
              f"(solve {stats['loop_solve_ms']} ms), ATE {stats['ate_m']} m, "
              f"fetch-blocked {stats['fetch_wait_s']}s of {stats['wall_s']}s",
              file=sys.stderr)
        return stats

    # per-frame deployment shape = the ring (ONE blocking fetch/frame);
    # the serial dispatch->fetch chain is kept as a comparison point and
    # as the ring's ATE-parity reference on the same tour
    per_frame = timed("ring", "full-SLAM per-frame (ring)")
    serial = timed(0, "full-SLAM per-frame (serial)")
    b8 = timed(8, "full-SLAM batched B=8")
    b32 = timed(32, "full-SLAM batched B=32")

    return {
        "full_slam_fps_1chip": per_frame["fps"],
        "full_slam_keyframes": per_frame["keyframes"],
        "full_slam_loops_closed": per_frame["loops_closed"],
        "full_slam_loop_solve_ms": per_frame["loop_solve_ms"],
        "full_slam_rpcs_per_frame": per_frame["rpcs_per_frame"],
        "full_slam_ate_m": per_frame["ate_m"],
        "full_slam_serial_fps_1chip": serial["fps"],
        "full_slam_serial_rpcs_per_frame": serial["rpcs_per_frame"],
        "full_slam_serial_ate_m": serial["ate_m"],
        "full_slam_batched_fps_1chip": b8["fps"],
        "full_slam_batched_keyframes": b8["keyframes"],
        "full_slam_batched_loops_closed": b8["loops_closed"],
        "full_slam_batched_rpcs_per_frame": b8["rpcs_per_frame"],
        "full_slam_batched32_fps_1chip": b32["fps"],
        "full_slam_batched32_rpcs_per_frame": b32["rpcs_per_frame"],
        "full_slam_fetch_wait_s_b8": b8["fetch_wait_s"],
        "full_slam_host_busy_s_b8": b8["host_busy_s"],
        "full_slam_fetch_wait_s_b32": b32["fetch_wait_s"],
        "full_slam_host_busy_s_b32": b32["host_busy_s"],
    }


def main():
    import jax
    import jax.numpy as jnp

    from rgbdslam.config import SlamConfig
    from rgbdslam.frontend.frame import build_frame_features
    from rgbdslam.frontend.matcher import gather_matched_points, match_frames
    from rgbdslam.geometry.camera import SYNTHETIC
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.slam.pipeline import PipelinedOdometry
    from rgbdslam.solvers.ransac_se3 import ransac_se3
    from rgbdslam.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(f"device: {dev.device_kind} x {len(jax.devices())}; nvidia-smi: "
          f"{smi.stdout.strip()}", file=sys.stderr)
    enable_compile_cache()

    cfg = SlamConfig()
    cam = SYNTHETIC  # 640x480, the reference's native resolution
    ds = SyntheticDataset(n_frames=16, cam=cam, trajectory="sweep")
    frames = [ds.grab(i)[1:] for i in range(len(ds))]
    jax.block_until_ready(frames[-1])

    def tracking_step(f_ref, gray_cur, depth_cur, key):
        """One frame of VO: build current features, match vs the (cached)
        reference features, RANSAC — the Tracker's per-frame device work
        (the reference frame's features are reused, as in
        System/Tracking.cpp:121-131)."""
        f_cur = build_frame_features(cam, gray_cur, depth_cur, cfg.extractor)
        m = match_frames(f_ref, f_cur, cfg.matcher.nn_ratio)
        p1, p2, w, valid = gather_matched_points(f_ref, f_cur, m)
        res = ransac_se3(p1, p2, w, valid, key, cfg.ransac)
        return f_cur, res.T21, res.num_inliers

    step = jax.jit(tracking_step)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    feats = build_frame_features(cam, *frames[0], cfg.extractor)
    jax.block_until_ready(step(feats, *frames[1], key))
    print(f"single-step compile+first step: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    n_iters = 100
    t0 = time.perf_counter()
    for i in range(n_iters):
        key, sub = jax.random.split(key)
        feats, T21, n_inl = step(feats, *frames[(i + 1) % len(frames)], sub)
    jax.block_until_ready(T21)
    single_fps = n_iters / (time.perf_counter() - t0)

    # ---- pipelined mode: lax.scan chains B frames per dispatch -----------
    B = 8
    mstep = PipelinedOdometry(cam, cfg, batch=B).step
    grays = jnp.stack([frames[i % len(frames)][0] for i in range(B)])
    depths = jnp.stack([frames[i % len(frames)][1] for i in range(B)])
    feats = build_frame_features(cam, *frames[0], cfg.extractor)
    t0 = time.perf_counter()
    jax.block_until_ready(mstep(feats, grays, depths, key))
    print(f"pipelined compile+first batch: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    n_batches = 12
    t0 = time.perf_counter()
    f_c = feats
    for i in range(n_batches):
        key, sub = jax.random.split(key)
        f_c, outs = mstep(f_c, grays, depths, sub)
    jax.block_until_ready(f_c)
    dt = time.perf_counter() - t0
    fps = n_batches * B / dt
    print(f"pipelined (B={B}): {fps:.1f} frames/s "
          f"({dt / (n_batches * B) * 1e3:.3f} ms/frame); single-step: "
          f"{single_fps:.1f} frames/s, last inliers={int(n_inl)}",
          file=sys.stderr)

    result = {
        "metric": "tracking_fps_1chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "tracking_fps_single_dispatch": round(single_fps, 2),
        "device_kind": dev.device_kind,
    }
    result.update(measure_full_slam())
    print(f"full SLAM: {result['full_slam_fps_1chip']} frames/s "
          f"({result['full_slam_keyframes']} KFs, "
          f"{result['full_slam_loops_closed']} loops)", file=sys.stderr)
    cpu_fps = measure_cpu_anchor()
    result["cpu_fps_measured_this_host"] = round(cpu_fps, 2)
    print(f"cpu anchor (this host's CPU backend): {cpu_fps:.2f} frames/s",
          file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    if "--cpu-anchor-worker" in sys.argv:
        cpu_anchor_worker()
    else:
        main()
