"""Map growth past the preallocated budgets (VERDICT r2 missing #2).

The reference handles arbitrary-length sequences (Core/Map.cpp:10-132 —
unbounded std::map); SURVEY.md §7 hard part (e) prescribes fixed budgets
that spill/grow. Every store now doubles on demand: keyframe store, pose
graph (vertices + edges), loop-detector BoW table, landmark table, and the
device-resident keyframe bank (one recompile per power-of-two bucket).
"""

import numpy as np

import rgbdslam  # noqa: F401
from rgbdslam.config import (ExtractorConfig, KeyframeConfig, LoopConfig,
                             PoseGraphConfig, SlamConfig)
from rgbdslam.eval.ate import ate_rmse
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.slam.system import SlamSystem
from rgbdslam.solvers.pose_graph import PoseGraph


def test_pose_graph_grows_past_budgets():
    g = PoseGraph(max_vertices=8, max_edges=4)
    rng = np.random.default_rng(0)
    for k in range(30):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.normal(0, 0.1, 3).astype(np.float32) + [k * 0.1, 0, 0]
        g.add_vertex(T)
        if k > 0:
            g.add_odometry_edge(k, k - 1)
        if k > 5:
            g.add_edge(k, k - 3, np.eye(4, dtype=np.float32), weight=0.5)
    assert g.n_vertices == 30 and g.max_vertices >= 30
    assert g.n_edges == 29 + 24 and g.max_edges >= g.n_edges
    out = g.optimize(3)
    assert out.shape == (30, 4, 4)
    assert np.isfinite(out).all()


def test_full_system_grows_past_every_budget():
    """Drive the SLAM system far past every initial budget: the keyframe
    store, device bank, pose graph, BoW table, and landmark table must all
    double (repeatedly) without a RuntimeError, and the run must still
    produce a sane trajectory."""
    cam = Camera(130.0, 130.0, 79.5, 59.5, width=160, height=120)
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=256, num_levels=3, cell_size=6,
                                  fast_threshold=12.0, min_response=8.0,
                                  min_border=16),
        # tiny budgets so a short run crosses them all several times
        keyframe=KeyframeConfig(min_translation=0.02, min_rotation=0.02,
                                max_keyframes=4),
        pose_graph=PoseGraphConfig(max_edges=8),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=128),
        max_landmarks=512,
    )
    n = 40
    # partial tour: full speed over 40 frames means ~0.5 m/frame jumps
    ds = SyntheticDataset(n_frames=n, cam=cam, trajectory="tour", loops=0.35)
    system = SlamSystem(cam, cfg, seed=0)
    # shrink the detector's loop-side budget too
    system.loop_detector.bow_db = system.loop_detector.bow_db[:4].copy()
    for i in range(n):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()

    k = system.store.count
    assert k > 4, "gate too strict — test needs many keyframes"
    assert system.store.max_keyframes >= k
    assert system.graph.n_vertices == k
    assert system.graph.max_vertices >= k
    assert system.graph.n_edges > 8           # crossed the edge budget
    assert system.loop_detector.bow_db.shape[0] >= k
    assert system._bank[0].shape[0] >= k      # device bank doubled
    assert system.landmarks.count > 512       # crossed the landmark budget

    ts_c, poses_c = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_c, poses_c, ds.timestamps, ds.poses_twc)
    assert rmse < 0.25, f"growth run ATE {rmse:.3f}"
