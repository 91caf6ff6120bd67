"""Tests for trajectory IO, ATE/RPE evaluation, and the synthetic renderer."""

import io

import jax.numpy as jnp
import numpy as np

from rgbdslam.eval.ate import align_umeyama, associate, ate_rmse, rpe
from rgbdslam.geometry.camera import Camera
from rgbdslam.io import synthetic, trajectory
from rgbdslam.io.synthetic import SyntheticDataset, render_frame


def _random_traj(n, rng):
    from scipy.spatial.transform import Rotation as R

    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pos = np.cumsum(rng.normal(scale=0.1, size=(n, 3)), axis=0)
    for i in range(n):
        poses[i, :3, :3] = R.from_rotvec(rng.normal(scale=0.2, size=3)).as_matrix()
        poses[i, :3, 3] = pos[i]
    return poses


def test_tum_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    poses = _random_traj(20, rng)
    ts = np.arange(20, dtype=np.float64) * 0.033
    p = str(tmp_path / "traj.txt")
    trajectory.save_tum(p, ts, poses)
    ts2, poses2 = trajectory.load_tum(p)
    np.testing.assert_allclose(ts2, ts, atol=1e-6)
    np.testing.assert_allclose(poses2, poses, atol=1e-5)


def test_load_tum_skips_comments():
    text = "# comment\n0.0 0 0 0 0 0 0 1\n1.0 1 2 3 0 0 0 1\n"
    ts, poses = trajectory.load_tum(io.StringIO(text))
    assert len(ts) == 2
    np.testing.assert_allclose(poses[1, :3, 3], [1, 2, 3])


def test_associate():
    a = np.array([0.0, 1.0, 2.0])
    b = np.array([0.005, 1.5, 2.001])
    ia, ib = associate(a, b, max_dt=0.02)
    np.testing.assert_array_equal(ia, [0, 2])
    np.testing.assert_array_equal(ib, [0, 2])


def test_ate_zero_for_rigidly_transformed_traj():
    rng = np.random.default_rng(1)
    poses = _random_traj(50, rng)
    ts = np.arange(50, dtype=np.float64)
    # apply a global rigid transform: ATE must be ~0 after alignment
    from scipy.spatial.transform import Rotation as R

    G = np.eye(4, dtype=np.float32)
    G[:3, :3] = R.from_rotvec([0.3, -0.2, 0.9]).as_matrix()
    G[:3, 3] = [5.0, -2.0, 1.0]
    poses_g = np.einsum("ij,njk->nik", G, poses)
    rmse, info = ate_rmse(ts, poses, ts, poses_g)
    assert rmse < 1e-5
    assert info["pairs"] == 50


def test_ate_detects_error():
    rng = np.random.default_rng(2)
    poses = _random_traj(50, rng)
    ts = np.arange(50, dtype=np.float64)
    noisy = poses.copy()
    noisy[:, :3, 3] += rng.normal(scale=0.05, size=(50, 3))
    rmse, _ = ate_rmse(ts, noisy, ts, poses)
    assert 0.02 < rmse < 0.12


def test_rpe_identity():
    rng = np.random.default_rng(3)
    poses = _random_traj(30, rng)
    ts = np.arange(30, dtype=np.float64)
    t_err, r_err = rpe(ts, poses, ts, poses)
    assert t_err < 1e-6 and r_err < 1e-3


def test_umeyama_recovers_transform():
    rng = np.random.default_rng(4)
    from scipy.spatial.transform import Rotation as R

    src = rng.normal(size=(100, 3))
    R_true = R.from_rotvec([0.1, 0.5, -0.3]).as_matrix()
    t_true = np.array([1.0, 2.0, 3.0])
    dst = src @ R_true.T + t_true
    R_est, t_est, s = align_umeyama(src, dst)
    np.testing.assert_allclose(R_est, R_true, atol=1e-8)
    np.testing.assert_allclose(t_est, t_true, atol=1e-8)
    assert s == 1.0


# ---------------------------------------------------------------------------
# Synthetic renderer
# ---------------------------------------------------------------------------

SMALL_CAM = Camera(80.0, 80.0, 63.5, 47.5, width=128, height=96)


def test_render_frame_shapes_and_depth_consistency():
    ds = SyntheticDataset(n_frames=4, cam=SMALL_CAM)
    ts, gray, depth = ds.grab(0)
    assert gray.shape == (96, 128) and depth.shape == (96, 128)
    g = np.asarray(gray)
    d = np.asarray(depth)
    assert np.all(d > 0.1) and np.all(d < 12.0)  # inside the room, walls visible
    assert g.std() > 10.0  # textured

    # Depth must be geometrically consistent: backproject pixel -> world point
    # must lie on a wall of the box.
    from rgbdslam.geometry import camera as cm

    pts_c = np.asarray(cm.depth_to_points(SMALL_CAM, depth))
    Twc = ds.poses_twc[0]
    pts_w = pts_c.reshape(-1, 3) @ Twc[:3, :3].T + Twc[:3, 3]
    half = np.asarray(synthetic.ROOM_HALF)
    dist_to_wall = np.min(np.abs(np.abs(pts_w) - half), axis=-1)
    assert np.percentile(dist_to_wall, 99) < 1e-2


def test_render_deterministic():
    g1, d1 = render_frame(SMALL_CAM, jnp.eye(4))
    g2, d2 = render_frame(SMALL_CAM, jnp.eye(4))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))


def test_orbit_closes_loop():
    poses = synthetic.orbit_trajectory(100)
    gap = np.linalg.norm(poses[0, :3, 3] - poses[-1, :3, 3])
    assert gap < 0.15


def test_poses_are_rigid():
    poses = synthetic.orbit_trajectory(10)
    for T in poses:
        RtR = T[:3, :3].T @ T[:3, :3]
        np.testing.assert_allclose(RtR, np.eye(3), atol=1e-5)
        assert np.linalg.det(T[:3, :3]) > 0.99


def test_html_viewer_export(tmp_path):
    from rgbdslam.viz.export import save_html_viewer

    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 500).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5)
    p = str(tmp_path / "v.html")
    save_html_viewer(p, xyz, inten, poses)
    html = open(p).read()
    assert "<canvas" in html and "PTS=" in html
    assert html.count(",") > 1000  # data actually embedded
    # subsampling cap
    save_html_viewer(p, np.tile(xyz, (500, 1)), None, None, max_points=1000)
    assert len(open(p).read()) < 10_000_000
