"""End-to-end visual odometry on a synthetic sequence: ATE against ground truth.

This is the round-1 "minimum end-to-end slice" check (SURVEY.md §7 layer 5):
frames -> features -> matching -> RANSAC -> pose composition -> trajectory ->
ATE, entirely through the public API.
"""

import numpy as np
import pytest

from rgbdslam.config import ExtractorConfig, SlamConfig
from rgbdslam.eval.ate import ate_rmse, rpe
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.slam.tracking import Tracker, TrackerState

CAM = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                              fast_threshold=15.0)
)


@pytest.fixture(scope="module")
def sweep_run():
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep")
    tracker = Tracker(CAM, CFG, seed=0)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        tracker.track(ts, gray, depth)
    return ds, tracker


def test_odometry_tracks_all_frames(sweep_run):
    ds, tracker = sweep_run
    assert len(tracker.trajectory) == len(ds)
    assert tracker.state is TrackerState.OK
    # failure rate low
    assert tracker.stats.failures <= 2


def test_odometry_ate(sweep_run):
    ds, tracker = sweep_run
    ts, poses = tracker.camera_trajectory()
    gt_ts = ds.timestamps
    gt = ds.poses_twc
    rmse, info = ate_rmse(ts, poses, gt_ts, gt)
    assert info["pairs"] == len(ds)
    # sweep covers ~3.2 m of travel; sub-2cm ATE expected from clean synthetic
    assert rmse < 0.05, f"ATE RMSE {rmse:.4f} m (detail: {info})"


def test_odometry_rpe(sweep_run):
    ds, tracker = sweep_run
    ts, poses = tracker.camera_trajectory()
    t_err, r_err = rpe(ts, poses, ds.timestamps, ds.poses_twc, delta=1)
    assert t_err < 0.02, f"RPE trans {t_err}"
    assert r_err < 0.02, f"RPE rot {r_err}"


def test_keyframes_created(sweep_run):
    ds, tracker = sweep_run
    # sweep moves ~3 m total; with a 0.2 m / 10 deg gate several KFs must exist
    assert 2 <= len(tracker.keyframes) <= len(ds)
    ts, poses = tracker.keyframe_trajectory()
    assert poses.shape == (len(tracker.keyframes), 4, 4)


def test_mean_inliers_tracked(sweep_run):
    _, tracker = sweep_run
    assert tracker.stats.mean_inliers > 30


def test_odometry_with_dense_icp():
    """Dense-ICP-polished odometry (the ICL-NUIM dense config) tracks at
    least as well as the sparse-only path on a short sweep."""
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                                  fast_threshold=15.0),
        use_dense_icp=True,
    )
    ds = SyntheticDataset(n_frames=24, cam=CAM, trajectory="sweep")
    tracker = Tracker(CAM, cfg, seed=0)
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        tracker.track(ts, gray, depth)
    ts_e, poses = tracker.camera_trajectory()
    rmse, info = ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)
    assert tracker.stats.failures == 0
    assert rmse < 0.05, f"dense-ICP ATE {rmse}"
