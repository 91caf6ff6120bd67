"""Camera model tests: projection/unprojection/distortion roundtrips."""

import jax.numpy as jnp
import numpy as np

from rgbdslam.geometry import camera as cam_mod
from rgbdslam.geometry.camera import TUM_FR1, TUM_FR3, ICL_NUIM, Camera


def test_project_unproject_roundtrip():
    cam = TUM_FR3
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [cam.width - 1, cam.height - 1], size=(256, 2)).astype(np.float32)
    z = rng.uniform(0.5, 4.0, size=(256,)).astype(np.float32)
    pts = cam_mod.unproject(cam, jnp.asarray(uv), jnp.asarray(z))
    uv_rt = np.asarray(cam_mod.project(cam, pts))
    np.testing.assert_allclose(uv_rt, uv, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pts)[:, 2], z)


def test_undistort_roundtrip_fr1():
    """Iterative undistortion inverts the forward model (fr1 has strong
    distortion, IO/DatasetTUM.cpp:70-72)."""
    cam = TUM_FR1
    rng = np.random.default_rng(1)
    # stay in the central region where the model is well-behaved
    xn = rng.uniform(-0.4, 0.4, size=(512, 2)).astype(np.float32)
    xd = cam_mod.distort_normalized(cam, jnp.asarray(xn))
    xn_rt = np.asarray(cam_mod.undistort_normalized(cam, xd))
    np.testing.assert_allclose(xn_rt, xn, atol=1e-5)


def test_undistort_pixels_identity_when_no_distortion():
    cam = TUM_FR3
    uv = jnp.array([[10.0, 20.0], [300.0, 200.0]], dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(cam_mod.undistort_pixels(cam, uv)), np.asarray(uv)
    )


def test_icl_negative_fy():
    """ICL-NUIM uses fy = -480 (inverted y, IO/DatasetICL.cpp:37-39);
    roundtrip must still hold."""
    cam = ICL_NUIM
    uv = jnp.array([[320.0, 100.0]], dtype=jnp.float32)
    z = jnp.array([2.0], dtype=jnp.float32)
    pts = cam_mod.unproject(cam, uv, z)
    assert float(pts[0, 1]) > 0  # y flipped
    uv_rt = np.asarray(cam_mod.project(cam, pts))
    np.testing.assert_allclose(uv_rt, np.asarray(uv), atol=1e-4)


def test_depth_to_points_consistency():
    cam = Camera(525.0, 525.0, 319.5, 239.5, width=64, height=48)
    depth = jnp.full((48, 64), 2.0, dtype=jnp.float32)
    pts = cam_mod.depth_to_points(cam, depth)
    assert pts.shape == (48, 64, 3)
    # center pixel maps near the optical axis
    uv_rt = np.asarray(cam_mod.project(cam, pts.reshape(-1, 3)))
    uu, vv = np.meshgrid(np.arange(64), np.arange(48))
    ref = np.stack([uu.ravel(), vv.ravel()], axis=-1)
    np.testing.assert_allclose(uv_rt, ref, atol=1e-3)


def test_bearing_unit_norm():
    cam = TUM_FR3
    uv = jnp.array([[100.0, 100.0], [500.0, 400.0]], dtype=jnp.float32)
    b = np.asarray(cam_mod.bearing(cam, uv))
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-6)


def test_valid_depth_and_bounds():
    cam = TUM_FR3
    depth = jnp.array([0.0, 0.05, 1.0, 5.9, 7.0, jnp.nan], dtype=jnp.float32)
    mask = np.asarray(cam_mod.valid_depth(cam, depth))
    np.testing.assert_array_equal(mask, [False, False, True, True, False, False])
    uv = jnp.array([[0.0, 0.0], [639.0, 479.0], [640.0, 100.0], [-1.0, 5.0]], dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(cam_mod.in_bounds(cam, uv)), [True, True, False, False]
    )
