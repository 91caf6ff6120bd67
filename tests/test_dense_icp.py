"""Dense projective ICP tests on rendered synthetic depth."""

import jax.numpy as jnp
import numpy as np

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.solvers.dense_icp import dense_icp, depth_normals, scaled_camera

CAM = Camera(160.0, 160.0, 127.5, 95.5, width=256, height=192)


def test_depth_normals_on_wall():
    """Flat wall straight ahead -> normals along -z (toward camera)."""
    depth = jnp.full((64, 64), 2.0)
    cam = Camera(64.0, 64.0, 31.5, 31.5, width=64, height=64)
    pts, n = depth_normals(cam, depth)
    inner = np.asarray(n)[10:-10, 10:-10]
    nz = inner[..., 2]
    assert np.all(np.abs(nz) > 0.95)
    assert np.all(nz < 0)  # oriented toward the camera


def test_dense_icp_recovers_interframe_motion():
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep")
    _, _, d0 = ds.grab(0)
    _, _, d1 = ds.grab(1)
    T21_gt = np.linalg.inv(ds.poses_twc[1]) @ ds.poses_twc[0]

    T = dense_icp(CAM, d0, d1, jnp.eye(4), levels=(4, 2), iters_per_level=10)
    err = np.linalg.inv(np.asarray(T)) @ T21_gt
    tn = float(se3.translation_norm(jnp.asarray(err)))
    rn = float(se3.rotation_angle(jnp.asarray(err)))
    # blocky-texture-free geometry: depth-only alignment on a box room has a
    # sliding ambiguity along flat walls; still must be within a few cm here
    assert tn < 0.05, tn
    assert rn < 0.02, rn


def test_dense_icp_improves_on_coarse_init():
    # sweep views keep several wall orientations in frame — the point-to-
    # plane system is well-constrained (orbit side-views slide along walls)
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep")
    _, _, d0 = ds.grab(0)
    _, _, d2 = ds.grab(2)
    T21_gt = np.linalg.inv(ds.poses_twc[2]) @ ds.poses_twc[0]
    # perturb ground truth as a coarse init
    noise = np.asarray(
        se3.exp(jnp.asarray(np.r_[0.02, -0.02, 0.02, 0.01, -0.01, 0.01].astype(np.float32)))
    )
    T0 = jnp.asarray(noise @ T21_gt.astype(np.float32))
    T = dense_icp(CAM, d0, d2, T0, levels=(4, 2), iters_per_level=8)
    err0 = np.linalg.inv(np.asarray(T0)) @ T21_gt
    err1 = np.linalg.inv(np.asarray(T)) @ T21_gt
    tn0 = float(se3.translation_norm(jnp.asarray(err0)))
    tn1 = float(se3.translation_norm(jnp.asarray(err1)))
    assert tn1 < tn0, (tn1, tn0)


def test_scaled_camera():
    c2 = scaled_camera(CAM, 2)
    assert c2.width == 128 and c2.height == 96
    assert c2.fx == CAM.fx / 2
