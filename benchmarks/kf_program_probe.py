"""Probe: where the batched full-SLAM wall clock goes.

Measures each device component of a batched full-SLAM run, so the fps
ceiling is an accounting identity, not a guess:

1. per-keyframe fused backend program (bank insert + store packing +
   batched proximity RANSAC verification + landmark-track extension + BoW
   quantize & scores, slam/system.py::_kf_core) — slope-timed over chained
   dispatches (cancels the RTT constant). Two pose layouts bracket the
   proximity work: 'spread' (0.3 m apart -> few candidates, typical) and
   'stacked' (same pose -> the candidate list saturates at
   max_proximity_candidates, worst case).
2. the B-frame VO scan (slam/tracking.py::_batch_step) — one clean
   dispatch + block_until_ready (the device-compute term per batch).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def time_kfs(system_factory, layout: str, n1: int = 4, n2: int = 24) -> dict:
    """Slope-timed per-KF cost of the fused backend program.

    Measurement caveat (ADVICE r3): the timed loop runs `_kf_dispatch`, so
    the slope includes the per-KF HOST work inside it (center argsort,
    has_edge scans, meta packing) and the dispatch-enqueue overhead — it is
    an UPPER BOUND on a host+device pipeline step, not pure device compute.
    The device-only figure would need pre-built metas + direct _kf_fused
    calls; the pipeline bound is what the full-SLAM wall actually pays, so
    it is the number the BASELINE time-budget table wants."""
    import jax

    def run(n: int) -> float:
        system = system_factory()
        f = system._probe_feats
        t0 = time.perf_counter()
        for k in range(n):
            if layout == "spread":
                Tcw = np.eye(4, dtype=np.float32)
                Tcw[0, 3] = 0.3 * k
            else:
                Tcw = np.eye(4, dtype=np.float32)
            h = system._kf_dispatch(k, float(k), f, Tcw)
        jax.block_until_ready(h["blob"])
        return time.perf_counter() - t0

    run(2)                       # compile + warm
    best = {}
    for n in (n1, n2):
        best[n] = min(run(n) for _ in range(3))
    slope_ms = (best[n2] - best[n1]) / (n2 - n1) * 1e3
    return {"layout": layout, "per_kf_ms": round(slope_ms, 3),
            "wall_n1_s": round(best[n1], 3), "wall_n2_s": round(best[n2], 3)}


def time_vo_batch(tracker, feats, gs, dsb) -> dict:
    """One clean B-frame VO scan dispatch + block (device-compute term)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    carry = (feats, jnp.eye(4, dtype=jnp.float32), dsb[0],
             jnp.float32(20.0))
    key = jax.random.PRNGKey(0)
    _, _, _, packed = tracker._batch_step(*carry, gs, dsb, key)
    np.asarray(packed)                    # compile + drain
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _, _, _, packed = tracker._batch_step(*carry, gs, dsb, key)
        jax.block_until_ready(packed)
        best = min(best, time.perf_counter() - t0)
    B = int(gs.shape[0])
    return {"B": B, "batch_ms": round(best * 1e3, 1),
            "per_frame_ms": round(best / B * 1e3, 2)}


def main():
    import jax
    import jax.numpy as jnp

    from rgbdslam.config import SlamConfig
    from rgbdslam.frontend.frame import build_frame_features
    from rgbdslam.geometry.camera import SYNTHETIC
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.loop.vocabulary import shipped_vocabulary
    from rgbdslam.slam.system import SlamSystem
    from rgbdslam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    cam = SYNTHETIC
    cfg = SlamConfig()
    ds = SyntheticDataset(n_frames=1, cam=cam, trajectory="tour")
    _, gray, depth = ds.grab(0)
    feats = build_frame_features(cam, gray, depth, cfg.extractor)
    jax.block_until_ready(feats.desc)
    voc = shipped_vocabulary("svo_fast")

    def factory():
        s = SlamSystem(cam, cfg, seed=0)
        if voc:
            s.load_vocabulary(voc)
        s._probe_feats = feats
        return s

    out = {"device": str(jax.devices()[0]),
           "C_max_proximity": cfg.pose_graph.max_proximity_candidates}
    for layout in ("spread", "stacked"):
        r = time_kfs(factory, layout)
        out[layout] = r
        print(f"{layout}: {r['per_kf_ms']} ms/KF "
              f"(wall {r['wall_n1_s']}s -> {r['wall_n2_s']}s)",
              file=sys.stderr)

    B = 32
    dsb_frames = SyntheticDataset(n_frames=B, cam=cam, trajectory="tour")
    fs = [dsb_frames.grab(i)[1:] for i in range(B)]
    gs = jnp.stack([f[0] for f in fs])
    dsb = jnp.stack([f[1] for f in fs])
    np.asarray(dsb[0])
    vo = time_vo_batch(factory().tracker, feats, gs, dsb)
    out["vo_batch"] = vo
    print(f"VO scan B={vo['B']}: {vo['batch_ms']} ms/batch = "
          f"{vo['per_frame_ms']} ms/frame", file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
