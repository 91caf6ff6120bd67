"""Full-system integration test: orbit sequence with loop closure.

Exercises the complete pipeline of SURVEY.md §3: tracking -> keyframes ->
pose-graph construction (odometry + proximity edges) -> BoW loop detection ->
RANSAC loop verification -> global optimization -> trajectory correction.
"""

import numpy as np
import pytest

from rgbdslam.config import (
    ExtractorConfig,
    LoopConfig,
    PoseGraphConfig,
    SlamConfig,
)
from rgbdslam.eval.ate import ate_rmse
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.slam.system import SlamSystem

CAM = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                              fast_threshold=15.0),
    # orbit test sequence is short: shrink the loop gates accordingly
    # (reference gates: interval 100 ids / 15 KFs, System/Tracking.cpp:29,
    # Solver/PoseGraph.cpp:250)
    loop=LoopConfig(id_interval=12, min_kfs_since_loop=10, vocab_size=256),
)


@pytest.fixture(scope="module")
def orbit_run():
    ds = SyntheticDataset(n_frames=100, cam=CAM, trajectory="orbit", loops=1.15)
    system = SlamSystem(CAM, CFG, seed=0)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()
    return ds, system


def test_system_builds_graph(orbit_run):
    ds, system = orbit_run
    assert system.store.count >= 10
    assert system.graph.n_vertices == system.store.count
    # odometry edges exist at minimum
    assert system.graph.n_edges >= system.graph.n_vertices - 1


def test_system_proximity_edges(orbit_run):
    _, system = orbit_run
    # an orbit passing its start should generate at least a few extra edges
    # (proximity and/or loop) beyond the odometry chain
    assert system.graph.n_edges > system.graph.n_vertices - 1


def test_system_closes_loop(orbit_run):
    _, system = orbit_run
    assert system.loops_closed >= 1


def test_system_trajectory_accuracy(orbit_run):
    ds, system = orbit_run
    ts, poses = system.camera_trajectory()
    rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
    assert info["pairs"] == len(ds)
    assert rmse < 0.06, f"full-SLAM ATE {rmse:.4f} m ({info})"


def test_keyframe_trajectory_consistent(orbit_run):
    ds, system = orbit_run
    ts, poses = system.keyframe_trajectory()
    rmse, _ = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
    assert rmse < 0.06, f"KF ATE {rmse:.4f} m"


def test_system_with_sensor_noise():
    """Full SLAM under Kinect-class noise: loop machinery still works and
    ATE stays bounded."""
    ds = SyntheticDataset(n_frames=100, cam=CAM, trajectory="orbit",
                          loops=1.15, noise=True)
    system = SlamSystem(CAM, CFG, seed=0)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()
    ts_e, poses = system.camera_trajectory()
    rmse, info = ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)
    assert system.tracker.stats.failures <= 3
    assert rmse < 0.12, f"noisy full-SLAM ATE {rmse}"


def test_system_relocalizes_after_blackout():
    """5 blanked frames mid-sequence: the tracker enters LOST after
    `lost_after` consecutive failures and relocalizes against the BoW
    keyframe database once the scene returns, with the post-recovery
    trajectory matching ground truth again (VERDICT round-1 item 5 —
    beyond the reference, whose recover() only holds the pose,
    System/Tracking.cpp:195-199)."""
    from rgbdslam.slam.tracking import TrackerState

    ds = SyntheticDataset(n_frames=100, cam=CAM, trajectory="orbit",
                          loops=1.15)
    system = SlamSystem(CAM, CFG, seed=0)
    blank = range(40, 45)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        if i in blank:
            gray = np.zeros_like(np.asarray(gray))   # occluded sensor
            depth = np.zeros_like(np.asarray(depth))
        system.track(ts, gray, depth)
    system.finish()

    assert system.tracker.stats.relocalizations >= 1
    assert system.tracker.state is TrackerState.OK
    # post-recovery accuracy: ATE over the tail of the run stays in the
    # uninterrupted run's class (~0.04 m, test_system_trajectory_accuracy)
    ts_e, poses = system.camera_trajectory()
    tail = slice(50, None)
    rmse_tail, info = ate_rmse(ts_e[tail], poses[tail],
                               ds.timestamps[tail], ds.poses_twc[tail])
    assert info["pairs"] >= 40
    assert rmse_tail < 0.10, f"post-recovery ATE {rmse_tail:.4f} m"


def test_system_global_ba():
    """Global landmark-Schur BA after loop closure + at shutdown keeps (or
    improves) the pose-graph solution's accuracy."""
    from dataclasses import replace

    cfg = replace(CFG, use_global_ba=True, global_ba_iterations=4)
    ds = SyntheticDataset(n_frames=100, cam=CAM, trajectory="orbit",
                          loops=1.15)
    system = SlamSystem(CAM, cfg, seed=0)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
    system.finish()
    ts_e, poses = system.camera_trajectory()
    rmse, _ = ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)
    assert system.loops_closed >= 1
    assert rmse < 0.06, f"global-BA full-SLAM ATE {rmse:.4f} m"


def test_distorted_camera_end_to_end():
    """Full system through a TUM-fr1-class distorted camera (VERDICT round 1,
    weak #6): the renderer casts rays through the radial-tangential model and
    the frontend undistorts keypoints before unprojection
    (Core/Frame.cpp:251-281) — ATE must stay in the undistorted run's class.
    fr1's coefficients are strong (k1=0.26, k2=-0.95): an unhandled
    distortion chain fails this loudly."""
    cam_d = Camera(258.653, 258.235, 159.322, 127.657,
                   k1=0.262383, k2=-0.953104, k3=1.163314,
                   p1=-0.005358, p2=0.002628, width=320, height=240)
    cam_u = Camera(258.653, 258.235, 159.322, 127.657,
                   width=320, height=240)
    assert cam_d.has_distortion and not cam_u.has_distortion

    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=1024, num_levels=3,
                                  cell_size=8, fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10,
                        vocab_size=256),
    )

    def run(cam):
        ds = SyntheticDataset(n_frames=48, cam=cam, trajectory="orbit")
        system = SlamSystem(cam, cfg, seed=0)
        for i in range(len(ds)):
            ts, gray, depth = ds.grab(i)
            system.track(ts, gray, depth)
        system.finish()
        ts_arr, poses = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_arr, poses, ds.timestamps, ds.poses_twc)
        return rmse, system

    rmse_u, sys_u = run(cam_u)
    rmse_d, sys_d = run(cam_d)
    assert sys_d.tracker.stats.failures <= sys_u.tracker.stats.failures + 3
    assert rmse_u < 0.15, f"undistorted ATE {rmse_u}"
    # parity: the distorted chain may cost a little accuracy at the frame
    # edges (where fr1 distortion is several pixels) but must stay in class
    assert rmse_d < max(2.5 * rmse_u, 0.12), (
        f"distorted ATE {rmse_d} vs undistorted {rmse_u}")


def test_live_export_overlay_and_epoch_gated_octomap(tmp_path):
    """--live-export parity with the reference's live viewer (VERDICT r4
    item 5): during the run the out-dir holds a refreshing tracked-point
    overlay.png (Drawer/Viewer.cpp:122-128) and an octomap.npz whose
    big-change epoch bumps on loop closure (Drawer/MapDrawer.cpp:48-71,
    Core/Map.cpp:134-144)."""
    import os

    n = 100
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit",
                          loops=1.15)
    system = SlamSystem(CAM, CFG, seed=0)
    system.live_export = (5, str(tmp_path))
    epochs_seen = []
    for i in range(n):
        ts, gray, depth = ds.grab(i)
        system.track(ts, gray, depth)
        p = tmp_path / "octomap.npz"
        if p.exists():
            epochs_seen.append(int(np.load(p)["epoch"]))
    system.finish()

    assert system.loops_closed >= 1
    assert system.live_exports_written >= 2
    assert (tmp_path / "map_viewer.html").exists()
    assert (tmp_path / "trajectory.png").exists()
    # overlay refreshed with the latest keyframe's tracked points
    assert (tmp_path / "overlay.png").exists()
    assert os.path.getsize(tmp_path / "overlay.png") > 1000
    # occupancy grid written DURING the run (initial epoch-0 build), and
    # the epoch advances after the loop closure — the post-closure rebuild
    # lands at the next export tick or the guaranteed shutdown export
    assert epochs_seen, "octomap.npz never appeared during the run"
    assert epochs_seen[0] == 0
    assert system.map_epoch >= 1
    final_epoch = int(np.load(tmp_path / "octomap.npz")["epoch"])
    assert final_epoch == system.map_epoch >= 1
    from rgbdslam.mapping.occupancy import load_grid, occupied_voxels

    grid = load_grid(str(tmp_path / "octomap.npz"))
    centers, _cols = occupied_voxels(grid)
    assert len(centers) > 50       # a real map, not an empty grid


def test_pipelined_ring_matches_per_frame():
    """track_pipelined (depth-2 dispatch/fetch ring, VERDICT r4 item 3)
    must reproduce the serial per-frame trajectory. Unlike batched mode the
    ring keeps the HOST keyframe gate and the ref2 retry, and the relative
    order of {keyframe backend for frame i-1} vs {frame i's pose
    composition} is identical to serial — so with ADAPTIVE off the two
    paths compute the same numbers and parity is tight, loop closure
    included."""
    n = 100
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit",
                          loops=1.15)
    frames = [ds.grab(i) for i in range(n)]

    s1 = SlamSystem(CAM, CFG, seed=0)
    for ts, g, d in frames:
        s1.track(ts, g, d)
    s1.finish()
    t1, p1 = s1.camera_trajectory()
    r1, _ = ate_rmse(t1, p1, ds.timestamps, ds.poses_twc)

    s2 = SlamSystem(CAM, CFG, seed=0)
    for ts, g, d in frames:
        s2.track_pipelined(ts, g, d)
    s2.track_pipelined_flush()
    s2.finish()
    t2, p2 = s2.camera_trajectory()
    r2, _ = ate_rmse(t2, p2, ds.timestamps, ds.poses_twc)

    assert len(t2) == n
    assert s2.store.count == s1.store.count
    assert s2.loops_closed == s1.loops_closed >= 1
    assert s2.tracker.stats.failures == s1.tracker.stats.failures
    assert r1 < 0.06 and r2 < 0.06, (r1, r2)
    # residual divergence comes only from the keyframe backend completing
    # one frame late (the loop solve sees the same edges from a one-frame-
    # shifted host state); measured 5.8 mm max on this orbit
    diff = np.linalg.norm(p2[:, :3, 3] - p1[:, :3, 3], axis=-1)
    assert float(diff.max()) < 0.02, f"ring divergence {diff.max():.5f} m"


def test_batched_tracking_matches_per_frame():
    """track_batch (B frames per dispatch, on-device keyframe gate,
    pipelined backend dispatch/complete) must reproduce the per-frame
    system's trajectory quality — same keyframes, same loop closures,
    ATE in the same class (exact equality is not expected: batched mode
    has no second-reference retry and corrections land at batch
    boundaries)."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=512, num_levels=3,
                                  cell_size=8, fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10,
                        vocab_size=256),
    )
    n, B = 48, 8
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit")
    frames = [ds.grab(i) for i in range(n)]

    s1 = SlamSystem(CAM, cfg, seed=0)
    for ts, g, d in frames:
        s1.track(ts, g, d)
    s1.finish()
    t1, p1 = s1.camera_trajectory()
    r1, _ = ate_rmse(t1, p1, ds.timestamps, ds.poses_twc)

    s2 = SlamSystem(CAM, cfg, seed=0)
    for i in range(0, n, B):
        c = frames[i:i + B]
        s2.track_batch([x[0] for x in c], [x[1] for x in c],
                       [x[2] for x in c])
    s2.finish()
    t2, p2 = s2.camera_trajectory()
    r2, _ = ate_rmse(t2, p2, ds.timestamps, ds.poses_twc)

    assert len(t2) == n
    # keyframe counts agree up to gate jitter (the in-scan gate can't see
    # same-batch backend pose corrections)
    assert abs(s2.store.count - s1.store.count) <= 0.2 * s1.store.count + 1
    assert r1 < 0.12 and r2 < 0.12, (r1, r2)
    assert r2 < max(1.5 * r1, 0.05), (r2, r1)


def test_double_buffered_batches_match_sequential():
    """Dispatch-ahead pipelining (track_batch_dispatch(i+1) before
    track_batch_complete(i)) must reproduce the sequential track_batch
    trajectory exactly when ADAPTIVE is off: the scan carry chains on
    device and is independent of host completion."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=512, num_levels=3,
                                  cell_size=8, fast_threshold=15.0),
        loop=LoopConfig(id_interval=12, min_kfs_since_loop=10,
                        vocab_size=256),
    )
    n, B = 32, 8
    ds = SyntheticDataset(n_frames=n, cam=CAM, trajectory="orbit")
    frames = [ds.grab(i) for i in range(n)]

    s1 = SlamSystem(CAM, cfg, seed=0)
    for i in range(0, n, B):
        c = frames[i:i + B]
        s1.track_batch([x[0] for x in c], [x[1] for x in c],
                       [x[2] for x in c])
    s1.finish()
    t1, p1 = s1.camera_trajectory()

    s2 = SlamSystem(CAM, cfg, seed=0)
    pending = None
    for i in range(0, n, B):
        c = frames[i:i + B]
        h = s2.track_batch_dispatch([x[0] for x in c], [x[1] for x in c],
                                    [x[2] for x in c])
        if pending is not None:
            s2.track_batch_complete(pending)
        pending = h
    s2.track_batch_complete(pending)
    s2.finish()
    t2, p2 = s2.camera_trajectory()

    assert s1.store.count == s2.store.count
    np.testing.assert_allclose(p2, p1, atol=1e-5)
