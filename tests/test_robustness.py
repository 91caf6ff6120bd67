"""Failure detection / recovery tests (SURVEY.md §5.3): the tracker must
survive blank frames, depth dropouts, and resume accurately — the
reference's retry + recover() path (System/Tracking.cpp:132-143,195-199)."""

import numpy as np
import pytest

from rgbdslam.config import ExtractorConfig, SlamConfig
from rgbdslam.eval.ate import ate_rmse
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.slam.tracking import Tracker, TrackerState

CAM = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
CFG = SlamConfig(
    extractor=ExtractorConfig(num_features=1024, num_levels=3, cell_size=8,
                              fast_threshold=15.0)
)


def test_recovers_from_blank_frames():
    ds = SyntheticDataset(n_frames=30, cam=CAM, trajectory="sweep")
    tracker = Tracker(CAM, CFG, seed=0)
    blank_g = np.zeros((240, 320), np.float32)
    blank_d = np.zeros((240, 320), np.float32)

    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        if i in (12, 13):  # two consecutive dropouts (camera covered)
            tracker.track(ts, blank_g, blank_d)
        else:
            tracker.track(ts, g, d)

    # dropouts registered as failures, tracking resumed
    assert tracker.stats.failures >= 2
    assert tracker.state is TrackerState.OK
    assert len(tracker.trajectory) == 30

    # trajectory remains sane: evaluate only the clean tail after recovery
    ts_e, poses = tracker.camera_trajectory()
    rmse, info = ate_rmse(ts_e[16:], poses[16:], ds.timestamps[16:],
                          ds.poses_twc[16:])
    assert np.isfinite(rmse)
    # tail drift bounded: the hold-pose recovery leaves an offset, but
    # relative tracking afterwards must be consistent
    t_err, r_err = 0.0, 0.0
    from rgbdslam.eval.ate import rpe

    t_err, r_err = rpe(ts_e[16:], poses[16:], ds.timestamps[16:],
                       ds.poses_twc[16:])
    assert t_err < 0.05, t_err


def test_second_reference_retry():
    """A single bad frame must not break the chain: the next frame can still
    match against the second-most-recent reference
    (System/Tracking.cpp:132-143)."""
    ds = SyntheticDataset(n_frames=20, cam=CAM, trajectory="sweep")
    tracker = Tracker(CAM, CFG, seed=0)
    blank = np.zeros((240, 320), np.float32)
    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        if i == 8:
            tracker.track(ts, blank, blank)
        else:
            tracker.track(ts, g, d)
    # frame 9 matched against frame 7 (ref2) despite frame 8 being blank
    assert tracker.stats.failures <= 2
    ts_e, poses = tracker.camera_trajectory()
    rmse, _ = ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)
    assert rmse < 0.2


def test_depth_dropout_only():
    """Valid image but missing depth: no 3-D correspondences -> counted as a
    failure, pose held, later frames recover."""
    ds = SyntheticDataset(n_frames=16, cam=CAM, trajectory="sweep")
    tracker = Tracker(CAM, CFG, seed=0)
    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        if i == 7:
            tracker.track(ts, g, np.zeros((240, 320), np.float32))
        else:
            tracker.track(ts, g, d)
    assert tracker.state is TrackerState.OK
    assert len(tracker.trajectory) == 16


def test_tracking_under_sensor_noise():
    """Kinect-class noise (shot noise, z^2 depth noise, 3% dropouts): the
    pipeline's noise model (Mahalanobis gating, depth-validity masks) should
    keep ATE within a few cm."""
    ds = SyntheticDataset(n_frames=30, cam=CAM, trajectory="sweep", noise=True)
    tracker = Tracker(CAM, CFG, seed=0)
    for i in range(len(ds)):
        ts, g, d = ds.grab(i)
        tracker.track(ts, g, d)
    ts_e, poses = tracker.camera_trajectory()
    rmse, info = ate_rmse(ts_e, poses, ds.timestamps, ds.poses_twc)
    assert tracker.stats.failures <= 2
    assert rmse < 0.08, f"noisy ATE {rmse}"


def test_noise_is_deterministic():
    ds1 = SyntheticDataset(n_frames=2, cam=CAM, noise=True, seed=3)
    ds2 = SyntheticDataset(n_frames=2, cam=CAM, noise=True, seed=3)
    _, g1, d1 = ds1.grab(1)
    _, g2, d2 = ds2.grab(1)
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    # noise actually applied
    ds3 = SyntheticDataset(n_frames=2, cam=CAM, noise=False)
    _, g3, d3 = ds3.grab(1)
    assert not np.array_equal(np.asarray(g1), np.asarray(g3))
    assert (np.asarray(d1) == 0).mean() > 0.01  # dropouts present
