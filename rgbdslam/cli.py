"""Command-line driver: run SLAM over a dataset, export trajectories + maps.

The reference's driver is a hardcoded main() (main.cpp:14-55: dataset path,
extractor choice, vocabulary path baked in at compile time). This is the
configurable equivalent:

  python -m rgbdslam.cli --dataset synthetic:orbit --frames 150 \
      --out-dir /tmp/slam_out --export-ply --plot

  python -m rgbdslam.cli --dataset /data/rgbd_dataset_freiburg1_desk \
      --kind TUM --out-dir out/

Outputs (mirroring System/Tracking.cpp:270-317):
  CameraTrajectory.txt   full trajectory, TUM format
  KeyFrameTrajectory.txt keyframe trajectory, TUM format
plus optional map.npz (checkpoint), cloud PLY, and a top-down plot.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from rgbdslam.ops.backend import PLATFORMS, select_platform
from rgbdslam.utils.compile_cache import enable_compile_cache


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RGB-D SLAM on JAX")
    p.add_argument("--dataset", required=True,
                   help="dataset dir, or synthetic / synthetic:sweep / synthetic:orbit")
    p.add_argument("--kind", default="TUM", choices=["TUM", "ICL", "CORBS"],
                   help="dataset format for directory datasets")
    p.add_argument("--frames", type=int, default=150,
                   help="frame count (synthetic) or max frames (datasets)")
    p.add_argument("--out-dir", default="slam_out")
    p.add_argument("--odometry-only", action="store_true",
                   help="tracking only: no pose graph / loop closure")
    p.add_argument("--batch", type=int, default=1, metavar="B",
                   help="batched full SLAM: B frames per device dispatch "
                        "(scan-fused VO + on-device keyframe gate)")
    p.add_argument("--ring", action="store_true",
                   help="per-frame full SLAM through the depth-2 "
                        "dispatch/fetch ring: one blocking fetch per frame "
                        "(keyframe backend completes one frame late); the "
                        "low-latency per-frame deployment shape")
    p.add_argument("--pipelined", type=int, default=0, metavar="B",
                   help="odometry-only scan pipeline: B frames per device "
                        "dispatch (maximum throughput; no keyframes/backend)")
    p.add_argument("--dense-icp", action="store_true",
                   help="dense projective point-to-plane refinement per frame")
    p.add_argument("--noise-robust", action="store_true",
                   help="the measured noisy-sensor preset (BASELINE.md "
                        "ablation): dense ICP + shipped vocabulary "
                        "(0.217 -> 0.086 m on the Kinect-noise tour)")
    p.add_argument("--local-ba", action="store_true",
                   help="sliding-window landmark bundle adjustment")
    p.add_argument("--global-ba", action="store_true",
                   help="full-map landmark BA after loop closures + at "
                        "shutdown")
    p.add_argument("--detector", default="svo_fast",
                   choices=["svo_fast", "fast", "brief", "orb", "orb2",
                            "gftt", "star", "brisk", "freak", "latch",
                            "sift", "surf"])
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive FAST threshold (ADAPTIVE mode)")
    p.add_argument("--num-features", type=int, default=1024)
    p.add_argument("--cell-size", type=int, default=16)
    p.add_argument("--fast-threshold", type=float, default=20.0)
    p.add_argument("--vocabulary", default=None,
                   help="pre-trained loop-closure vocabulary (.npz from "
                        "rgbdslam.loop.vocabulary; the reference loads "
                        "voc_TUM_FAST_BRIEF.yml.gz at startup, main.cpp:32). "
                        "Default: the shipped artifact matching the detector "
                        "family (assets/voc_synth_*.npz); pass 'none' to "
                        "train online from the first keyframes instead")
    p.add_argument("--loop-interval", type=int, default=100,
                   help="min keyframe-id gap for loop candidates")
    p.add_argument("--save-map", action="store_true")
    p.add_argument("--export-ply", action="store_true")
    p.add_argument("--export-octomap", action="store_true",
                   help="rebuild the occupancy grid (octomap equivalent: "
                        "0.08 m log-odds voxels, hit 0.9/miss 0.4, "
                        "Drawer/OctomapDrawer.cpp:15-79) from every "
                        "keyframe's cloud under the FINAL optimized poses "
                        "-> octomap.npz + occupied-voxel PLY")
    p.add_argument("--export-html", action="store_true",
                   help="self-contained interactive 3-D map viewer "
                        "(map_viewer.html; the Pangolin Viewer analog for "
                        "headless hosts)")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="run the live backend solves (pose graph + global "
                        "BA) sharded over every visible device via shard_map "
                        "+ psum (parallel/dist_ba.py); no-op on 1 device")
    p.add_argument("--live-export", type=int, default=0, metavar="N",
                   help="during the run, rewrite map_viewer.html + "
                        "trajectory.png every N keyframes (the offline "
                        "analog of the reference's live Pangolin render "
                        "loop, Drawer/Viewer.cpp:83-136)")
    p.add_argument("--native-loader", action="store_true",
                   help="use the C++ prefetching PNG loader for disk datasets")
    p.add_argument("--eval-gt", default=None,
                   help="ground-truth TUM file for ATE (defaults to "
                        "<dataset>/groundtruth.txt or synthetic GT)")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timing report")
    p.add_argument("--platform", default="auto", choices=PLATFORMS,
                   help="JAX platform: auto (the GPU when one is visible), "
                        "cpu, or gpu (fails when no GPU is visible)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    select_platform(args.platform)
    enable_compile_cache()
    import numpy as np

    from rgbdslam.config import ExtractorConfig, LoopConfig, SlamConfig
    from rgbdslam.geometry.se3 import inverse_np as se3_np_inverse
    from rgbdslam.io import trajectory as traj_io
    from rgbdslam.io.datasets import open_dataset
    from rgbdslam.slam.system import SlamSystem
    from rgbdslam.slam.tracking import Tracker
    from rgbdslam.utils.profiling import StageTimer

    os.makedirs(args.out_dir, exist_ok=True)

    if args.dataset.startswith("synthetic"):
        ds = open_dataset(args.dataset, n_frames=args.frames)
    else:
        ds = open_dataset(args.dataset, kind=args.kind)

    cfg = SlamConfig(
        extractor=ExtractorConfig(
            num_features=args.num_features,
            cell_size=args.cell_size,
            fast_threshold=args.fast_threshold,
        ),
        loop=LoopConfig(id_interval=args.loop_interval),
        use_dense_icp=args.dense_icp or args.noise_robust,
        use_local_ba=args.local_ba,
        use_global_ba=args.global_ba,
        detector=args.detector,
        adaptive=args.adaptive,
        distributed=args.distributed,
    )

    if args.pipelined and not args.odometry_only:
        print("--pipelined implies --odometry-only", file=sys.stderr)
        args.odometry_only = True

    if args.odometry_only:
        system = None
        tracker = Tracker(ds.cam, cfg) if not args.pipelined else None
    else:
        system = SlamSystem(ds.cam, cfg)
        tracker = system.tracker
        vocab = args.vocabulary
        if vocab is None:
            # the reference never trains online — it loads a vocabulary at
            # startup (main.cpp:15,32); default to the shipped artifact for
            # the detector's descriptor family
            from rgbdslam.loop.vocabulary import shipped_vocabulary

            vocab = shipped_vocabulary(args.detector)
            if vocab:
                print(f"vocabulary: {vocab}", file=sys.stderr)
        if vocab and vocab.lower() != "none":
            system.load_vocabulary(vocab)
        if args.live_export > 0:
            system.live_export = (args.live_export, args.out_dir)

    timer = StageTimer()
    n = min(len(ds), args.frames)
    t_start = time.perf_counter()

    frame_iter = None
    if args.native_loader and hasattr(ds, "rgb_files"):
        from rgbdslam.native import framepipe as fp

        if fp.native_available():
            pipe = fp.FramePipe(ds.cam.width, ds.cam.height, n_workers=2,
                                capacity=8)
            items = [
                (os.path.join(ds.base_dir, ds.rgb_files[i]),
                 os.path.join(ds.base_dir, ds.depth_files[i]),
                 ds.cam.depth_factor)
                for i in range(n)
            ]
            frame_iter = (
                (ds.timestamps[tag], gray, depth)
                for gray, depth, tag in pipe.stream(items)
            )
        else:
            print("native loader unavailable; using python loader",
                  file=sys.stderr)

    if frame_iter is None:
        frame_iter = (ds.grab(i) for i in range(n))

    if args.pipelined:
        from rgbdslam.slam.pipeline import PipelinedOdometry

        pipe_odo = PipelinedOdometry(ds.cam, cfg, batch=args.pipelined)
        ts_c, poses_c, pstats = pipe_odo.run(frame_iter)
        wall = time.perf_counter() - t_start
        traj_io.save_tum(os.path.join(args.out_dir, "CameraTrajectory.txt"),
                         ts_c, poses_c)
        result = {"frames": int(pstats.get("frames", n)),
                  "fps": round(pstats.get("frames", n) / wall, 2),
                  "pipelined": args.pipelined,
                  "failures": pstats.get("failures", 0),
                  "mean_inliers": pstats.get("mean_inliers", 0)}
        gt = None
        if args.eval_gt:
            gt = traj_io.load_tum(args.eval_gt)
        elif hasattr(ds, "poses_twc"):
            gt = (ds.timestamps[:n], ds.poses_twc[:n])
        if gt is not None:
            from rgbdslam.eval.ate import ate_rmse

            rmse, info = ate_rmse(ts_c, poses_c, gt[0], gt[1])
            result.update(ate_rmse=round(rmse, 5),
                          ate_pairs=info.get("pairs", 0))
        print(json.dumps(result))
        return 0

    # keyframe image retention for the export-time occupancy rebuild
    # (the reference's Frame keeps its images, Core/Frame.h:24-216)
    keeper = None
    kf_seen = 0
    kf_skipped = 0
    if args.export_octomap and not args.odometry_only:
        from rgbdslam.viz.octomap_export import KeyframeImageKeeper

        keeper = KeyframeImageKeeper()

    def _retain_kf_images(chunk_items):
        nonlocal kf_seen, kf_skipped
        if keeper is None or not chunk_items:
            return
        by_ts = {float(it[0]): it for it in chunk_items}
        ts_max = max(by_ts)
        while kf_seen < len(tracker.keyframes):
            ts_k = float(tracker.keyframes[kf_seen][0])
            if ts_k in by_ts:
                _, g, d = by_ts[ts_k]
                keeper.offer(kf_seen, g, d)
            elif ts_k > ts_max:
                # keyframe from a frame this chunk hasn't delivered yet —
                # do NOT advance past it (ADVICE r4: a permanent advance on
                # a miss silently dropped the keyframe from the rebuild)
                break
            else:
                # genuinely unmatched (should not happen: keyframes are
                # created from tracked frames) — count + surface it
                kf_skipped += 1
                print(f"octomap: keyframe {kf_seen} (t={ts_k}) not found "
                      "in its frame chunk; excluded from rebuild",
                      file=sys.stderr)
            kf_seen += 1

    if args.batch > 1:
        # batched full SLAM: B frames per device dispatch (scan-fused VO +
        # on-device keyframe gate; backend per flagged keyframe)
        chunk = []
        done = 0
        for item in frame_iter:
            chunk.append(item)
            if len(chunk) == args.batch:
                with timer.stage("track"):
                    tracker.track_batch([c[0] for c in chunk],
                                        [c[1] for c in chunk],
                                        [c[2] for c in chunk])
                done += len(chunk)
                _retain_kf_images(chunk)
                chunk = []
                print(f"frame {done}/{n}  KFs={len(tracker.keyframes)}",
                      file=sys.stderr)
        if chunk:
            with timer.stage("track"):
                tracker.track_batch([c[0] for c in chunk],
                                    [c[1] for c in chunk],
                                    [c[2] for c in chunk])
            _retain_kf_images(chunk)
    elif args.ring:
        # per-frame dispatch/fetch ring (one blocking fetch per frame);
        # a frame's keyframe materializes one feed later, so image
        # retention always sees the previous frame too
        feed = (system.track_pipelined if system is not None
                else tracker.track_pipelined)
        prev_item = None
        for i, (ts, gray, depth) in enumerate(frame_iter):
            with timer.stage("track"):
                feed(ts, gray, depth)
            item = (ts, gray, depth)
            _retain_kf_images([item] if prev_item is None
                              else [prev_item, item])
            prev_item = item
            if (i + 1) % 50 == 0:
                print(f"frame {i+1}/{n}  KFs={len(tracker.keyframes)}",
                      file=sys.stderr)
        with timer.stage("track"):
            tracker.track_pipelined_flush()
        if prev_item is not None:
            _retain_kf_images([prev_item])
    else:
        track = system.track if system is not None else tracker.track
        for i, (ts, gray, depth) in enumerate(frame_iter):
            with timer.stage("track"):
                track(ts, gray, depth)
            _retain_kf_images([(ts, gray, depth)])
            if (i + 1) % 50 == 0:
                print(f"frame {i+1}/{n}  KFs={len(tracker.keyframes)} "
                      f"inliers={tracker._last_inliers}", file=sys.stderr)

    if system is not None:
        with timer.stage("final_optimize"):
            system.finish()
    wall = time.perf_counter() - t_start

    # --- exports (saveCameraTrajectory / saveKeyFrameTrajectory) -----------
    ts_c, poses_c = tracker.camera_trajectory()
    traj_io.save_tum(os.path.join(args.out_dir, "CameraTrajectory.txt"),
                     ts_c, poses_c)
    ts_k, poses_k = tracker.keyframe_trajectory()
    traj_io.save_tum(os.path.join(args.out_dir, "KeyFrameTrajectory.txt"),
                     ts_k, poses_k)

    result = {
        "frames": int(n),
        "fps": round(n / wall, 2),
        "keyframes": len(tracker.keyframes),
        "failures": tracker.stats.failures,
        "mean_inliers": tracker.stats.mean_inliers,
    }
    if tracker.stats.relocalizations:
        result["relocalizations"] = tracker.stats.relocalizations
    if system is not None:
        result["loops_closed"] = system.loops_closed
        result["graph_edges"] = system.graph.n_edges

    # --- evaluation --------------------------------------------------------
    gt = None
    if args.eval_gt:
        gt = traj_io.load_tum(args.eval_gt)
    elif hasattr(ds, "poses_twc"):
        gt = (ds.timestamps[:n], ds.poses_twc[:n])
    elif hasattr(ds, "ground_truth_path") and ds.ground_truth_path():
        gt = traj_io.load_tum(ds.ground_truth_path())
    if gt is not None:
        from rgbdslam.eval.ate import ate_rmse, rpe

        rmse, info = ate_rmse(ts_c, poses_c, gt[0], gt[1])
        rpe_t, rpe_r = rpe(ts_c, poses_c, gt[0], gt[1])
        result.update(ate_rmse=round(rmse, 5), ate_pairs=info.get("pairs", 0),
                      rpe_trans=round(rpe_t, 5), rpe_rot=round(rpe_r, 5))

    if args.save_map and system is not None:
        from rgbdslam.utils.serialization import save_map

        save_map(os.path.join(args.out_dir, "map.npz"), system)

    if args.export_ply and system is not None:
        from rgbdslam.viz.export import save_ply

        # rebuild KF clouds from the stored keyframes is not possible without
        # images; export the landmark-style sparse map instead: all valid
        # keypoint world points of every KF
        pts, cols = [], []
        for k in range(system.store.count):
            Tcw = system.store.poses_cw[k]
            Twc = se3_np_inverse(Tcw)
            xyz = system.store.xyz[k]
            ok = system.store.obs_valid[k]
            pw = xyz[ok] @ Twc[:3, :3].T + Twc[:3, 3]
            pts.append(pw)
            cols.append(system.store.intensity[k][ok])
        if pts:
            save_ply(os.path.join(args.out_dir, "map_points.ply"),
                     np.concatenate(pts), np.concatenate(cols))

    if keeper is not None and system is not None and keeper.images:
        from rgbdslam.mapping.occupancy import (occupied_voxels,
                                                save_grid)
        from rgbdslam.viz.export import save_ply
        from rgbdslam.viz.octomap_export import \
            build_occupancy_from_keyframes

        with timer.stage("octomap"):
            grid = build_occupancy_from_keyframes(
                ds.cam, keeper.images, system.store.poses_cw,
                cfg.keyframe)
            save_grid(os.path.join(args.out_dir, "octomap.npz"), grid)
            centers, cols = occupied_voxels(grid)
            if len(centers):
                save_ply(os.path.join(args.out_dir, "octomap_voxels.ply"),
                         centers, cols)
        result["octomap_voxels"] = int(len(centers))
        result["octomap_keyframes"] = len(keeper.images)
        result["octomap_kf_skipped"] = kf_skipped

    if args.export_html and system is not None:
        from rgbdslam.viz.export import save_html_viewer

        pw, inten = system.landmarks.world_points()
        K = system.store.count
        poses_twc = np.stack([se3_np_inverse(system.store.poses_cw[k])
                              for k in range(K)]) if K else None
        save_html_viewer(os.path.join(args.out_dir, "map_viewer.html"),
                         pw, inten, poses_twc)

    if args.plot:
        from rgbdslam.viz.export import plot_trajectories

        trajs, labels = [poses_c], ["estimate"]
        if gt is not None:
            trajs.append(gt[1])
            labels.append("ground truth")
        plot_trajectories(os.path.join(args.out_dir, "trajectory.png"),
                          trajs, labels)

    if args.profile:
        print(timer.report(), file=sys.stderr)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
