"""Noisy-sequence accuracy ablation (VERDICT r2 #4).

Runs the Kinect-noise multi-room tour (sigma_z = 0.0015 z^2, 3 % depth
dropout, image shot noise — io/synthetic.apply_sensor_noise) under each of
the accuracy features that shipped dark in round 2, one toggle at a time
plus the winning combination, and prints a table + JSON lines. The clean
tour runs alongside so a default set can be chosen without regressing the
clean path (BASELINE.md round-2 rows: clean 0.050 m / noisy 0.217 m).

Usage: python benchmarks/noise_ablation.py [--frames 96] [--platform cpu]
       [--configs base,mahal,...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_configs():
    from rgbdslam.config import (ExtractorConfig, LoopConfig,
                                 RansacConfig, SlamConfig)

    ext = ExtractorConfig(num_features=384, num_levels=3, cell_size=6,
                          fast_threshold=12.0, min_response=8.0,
                          min_border=16)
    loop = LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256)
    base = SlamConfig(extractor=ext, loop=loop)

    def var(**kw):
        return dataclasses.replace(base, **kw)

    return {
        "base": base,
        "mahal": var(ransac=RansacConfig(mahalanobis_refine=True)),
        "dense_icp": var(use_dense_icp=True),
        "local_ba": var(use_local_ba=True),
        "global_ba": var(use_global_ba=True),
        "subpixel": dataclasses.replace(
            base, extractor=dataclasses.replace(ext, subpixel=True)),
        "mahal+dense": var(ransac=RansacConfig(mahalanobis_refine=True),
                           use_dense_icp=True),
        "mahal+dense+gba": var(
            ransac=RansacConfig(mahalanobis_refine=True),
            use_dense_icp=True, use_global_ba=True),
        # shipped-vocabulary variants: the online 256-word codebook may be
        # too coarse to retrieve loop candidates under sensor noise, and a
        # missed loop closure dominates end-drift on the ~19 m tour
        "voc": base,
        "voc+mahal": var(ransac=RansacConfig(mahalanobis_refine=True)),
        "voc+dense": var(use_dense_icp=True),
        "voc+mahal+dense": var(
            ransac=RansacConfig(mahalanobis_refine=True),
            use_dense_icp=True),
        "voc+dense+gba": var(use_dense_icp=True, use_global_ba=True),
    }


def run_one(name, cfg, frames, noise: bool, seed: int = 0):
    import numpy as np

    from rgbdslam.eval.ate import ate_rmse
    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.slam.system import SlamSystem

    cam = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
    ds = SyntheticDataset(n_frames=frames, cam=cam, trajectory="tour",
                          noise=noise, seed=seed)
    system = SlamSystem(cam, cfg, seed=0)
    if name.startswith("voc"):
        from rgbdslam.loop.vocabulary import shipped_vocabulary

        system.load_vocabulary(shipped_vocabulary("svo_fast"))
    t0 = time.perf_counter()
    for i in range(frames):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()
    wall = time.perf_counter() - t0
    ts_c, poses_c = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
    return {
        "config": name, "noise": noise, "seed": seed,
        "ate_rmse": round(float(rmse), 4),
        "failures": system.tracker.stats.failures,
        "keyframes": system.store.count,
        "loops": system.loops_closed,
        "wall_s": round(wall, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--platform", default="cpu", choices=["auto", "cpu"])
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--clean-too", action="store_true",
                    help="also run each config on the clean tour")
    ap.add_argument("--seeds", type=int, default=1,
                    help="run noise seeds 0..N-1 per config and report "
                         "mean+-std (VERDICT r4 item 4: n=1 cannot "
                         "distinguish variance from regression)")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    configs = build_configs()
    names = (args.configs.split(",") if args.configs else list(configs))
    rows = []
    for name in names:
        cfg = configs[name]
        for seed in range(args.seeds):
            r = run_one(name, cfg, args.frames, noise=True, seed=seed)
            rows.append(r)
            print(json.dumps(r), flush=True)
        if args.clean_too:
            r = run_one(name, cfg, args.frames, noise=False)
            rows.append(r)
            print(json.dumps(r), flush=True)

    if args.seeds > 1:
        import numpy as np

        for name in names:
            ates = [r["ate_rmse"] for r in rows
                    if r["config"] == name and r["noise"]]
            loops = [r["loops"] for r in rows
                     if r["config"] == name and r["noise"]]
            print(json.dumps({
                "config": name, "summary": True, "n": len(ates),
                "ate_mean": round(float(np.mean(ates)), 4),
                "ate_std": round(float(np.std(ates)), 4),
                "ate_min": round(float(np.min(ates)), 4),
                "ate_max": round(float(np.max(ates)), 4),
                "loops_closed_runs": int(sum(1 for l in loops if l >= 1)),
            }), flush=True)

    print("\nconfig            noise  ATE      fails  KFs  loops",
          file=sys.stderr)
    for r in rows:
        print(f"{r['config']:<17} {str(r['noise']):<6} {r['ate_rmse']:<8} "
              f"{r['failures']:<6} {r['keyframes']:<4} {r['loops']}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
