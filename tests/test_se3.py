"""Unit tests for SE(3)/SO(3)/quaternion math against scipy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.geometry import se3


def random_rotvecs(n, rng, max_angle=np.pi - 0.05):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = rng.uniform(0, max_angle, size=(n, 1))
    return axes * angles


def test_so3_exp_matches_scipy():
    rng = np.random.default_rng(0)
    phi = random_rotvecs(64, rng).astype(np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(phi)))
    R_ref = ScipyRot.from_rotvec(phi).as_matrix()
    np.testing.assert_allclose(R, R_ref, atol=1e-5)


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(1)
    phi = random_rotvecs(64, rng).astype(np.float32)
    phi_rt = np.asarray(se3.so3_log(se3.so3_exp(jnp.asarray(phi))))
    np.testing.assert_allclose(phi_rt, phi, atol=2e-4)


def test_so3_log_small_angle():
    phi = jnp.array([[1e-5, -2e-5, 1e-6], [0.0, 0.0, 0.0]], dtype=jnp.float32)
    phi_rt = np.asarray(se3.so3_log(se3.so3_exp(phi)))
    np.testing.assert_allclose(phi_rt, np.asarray(phi), atol=1e-6)


def test_so3_log_near_pi():
    rng = np.random.default_rng(2)
    axes = rng.normal(size=(32, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    phi = (axes * (np.pi - 1e-4)).astype(np.float32)
    R = ScipyRot.from_rotvec(phi).as_matrix().astype(np.float32)
    phi_rt = np.asarray(se3.so3_log(jnp.asarray(R)))
    R_rt = ScipyRot.from_rotvec(phi_rt).as_matrix()
    # axis sign can flip at exactly pi; compare rotations, not vectors
    np.testing.assert_allclose(R_rt, R, atol=1e-3)


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(3)
    xi = np.concatenate(
        [rng.normal(scale=2.0, size=(64, 3)), random_rotvecs(64, rng, 3.0)], axis=-1
    ).astype(np.float32)
    T = se3.exp(jnp.asarray(xi))
    xi_rt = np.asarray(se3.log(T))
    np.testing.assert_allclose(xi_rt, xi, atol=2e-3)


def test_se3_inverse_compose():
    rng = np.random.default_rng(4)
    xi = rng.normal(scale=0.5, size=(16, 6)).astype(np.float32)
    T = se3.exp(jnp.asarray(xi))
    TI = T @ se3.inverse(T)
    np.testing.assert_allclose(
        np.asarray(TI), np.broadcast_to(np.eye(4), (16, 4, 4)), atol=1e-5
    )


def test_transform_points():
    rng = np.random.default_rng(5)
    xi = rng.normal(scale=0.5, size=(6,)).astype(np.float32)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    T = np.asarray(se3.exp(jnp.asarray(xi)))
    out = np.asarray(se3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    ref = pts @ T[:3, :3].T + T[:3, 3]
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_quat_roundtrip_and_scipy():
    rng = np.random.default_rng(6)
    phi = random_rotvecs(64, rng).astype(np.float32)
    R = ScipyRot.from_rotvec(phi).as_matrix().astype(np.float32)
    q = np.asarray(se3.quat_from_rotation(jnp.asarray(R)))
    q_ref = ScipyRot.from_matrix(R).as_quat()  # scipy: (x, y, z, w)
    # quaternions are sign-ambiguous
    sign = np.sign(np.sum(q * q_ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(q * sign, q_ref, atol=1e-5)
    R_rt = np.asarray(se3.rotation_from_quat(jnp.asarray(q)))
    np.testing.assert_allclose(R_rt, R, atol=1e-5)


def test_tnorm_rnorm_semantics():
    """translation_norm/rotation_angle mirror Tracking's tnorm/rnorm
    (System/Tracking.cpp:201-211)."""
    rng = np.random.default_rng(7)
    phi = random_rotvecs(1, rng, 1.0)[0].astype(np.float32)
    t = np.array([0.1, -0.2, 0.3], dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec(phi).as_matrix()
    T[:3, 3] = t
    assert np.isclose(float(se3.translation_norm(jnp.asarray(T))), np.linalg.norm(t), atol=1e-6)
    assert np.isclose(
        float(se3.rotation_angle(jnp.asarray(T))), np.linalg.norm(phi), atol=1e-4
    )


def test_adjoint_property():
    """Ad_T relates tangent vectors: exp(Ad_T xi) == T exp(xi) T^-1."""
    rng = np.random.default_rng(8)
    xi_T = rng.normal(scale=0.4, size=(6,)).astype(np.float32)
    xi = rng.normal(scale=0.2, size=(6,)).astype(np.float32)
    T = se3.exp(jnp.asarray(xi_T))
    lhs = se3.exp(se3.adjoint(T) @ jnp.asarray(xi))
    rhs = T @ se3.exp(jnp.asarray(xi)) @ se3.inverse(T)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-4)


def test_jit_and_vmap():
    rng = np.random.default_rng(9)
    xi = rng.normal(scale=0.3, size=(8, 6)).astype(np.float32)
    f = jax.jit(jax.vmap(se3.exp))
    T = f(jnp.asarray(xi))
    assert T.shape == (8, 4, 4)


def test_so3_log_exact_pi_arbitrary_axis():
    """Regression: 180-degree rotations about axes with all components
    below sqrt(1/2) previously returned a wrong axis (sign-flip bug)."""
    for a in [
        np.array([1.0, 1.0, 1.0]) / np.sqrt(3),
        np.array([0.3, -0.5, 0.81]) / np.linalg.norm([0.3, -0.5, 0.81]),
        np.array([1.0, 0.0, 0.0]),
    ]:
        R = (2 * np.outer(a, a) - np.eye(3)).astype(np.float32)
        phi = np.asarray(se3.so3_log(jnp.asarray(R)))
        R_rt = ScipyRot.from_rotvec(phi).as_matrix()
        np.testing.assert_allclose(R_rt, R, atol=1e-5)


def test_so3_log_conditioning_near_pi():
    """Angles within a few millirad of pi must reconstruct accurately (the
    sin(arccos(.)) formulation lost ~0.1 of absolute accuracy there)."""
    rng = np.random.default_rng(42)
    worst = 0.0
    for _ in range(100):
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        th = np.pi - rng.uniform(0, 5e-3)
        R = ScipyRot.from_rotvec(ax * th).as_matrix().astype(np.float32)
        phi = np.asarray(se3.so3_log(jnp.asarray(R)))
        worst = max(worst, np.abs(ScipyRot.from_rotvec(phi).as_matrix() - R).max())
    assert worst < 2e-3, worst


def test_orthonormalize_np_projects_and_preserves_translation():
    rng = np.random.default_rng(7)
    R = ScipyRot.random(8, rng=7).as_matrix().astype(np.float32)
    t = rng.normal(size=(8, 3)).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    T[:, :3, :3] = R * 1.013          # scale-drifted rotation block
    T[:, :3, 3] = t
    out = se3.orthonormalize_np(T)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out[:, :3, 3], t, atol=0)
    RtR = np.einsum("nij,nik->njk", out[:, :3, :3], out[:, :3, :3])
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (8, 1, 1)), atol=1e-6)
    # nearest rotation to s*R (s>0) is R itself
    np.testing.assert_allclose(out[:, :3, :3], R, atol=1e-5)
    # single (4,4) form
    one = se3.orthonormalize_np(T[0])
    np.testing.assert_allclose(one, out[0], atol=1e-6)


def test_inverse_np_mirrors_scale_error_motivation():
    """The failure mode orthonormalize_np exists for: for a scale-drifted
    pose s*R the closed-form inverse carries s (not 1/s), so the
    apply_correction composition ref @ inverse_np(old) @ new AMPLIFIES a
    shared scale error instead of cancelling it; after projection the
    composition is exact."""
    R = ScipyRot.random(1, rng=3).as_matrix()[0].astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    s = 1.01
    T[:3, :3] = s * R
    T[:3, 3] = [0.3, -0.2, 1.0]
    scale = lambda M: np.cbrt(abs(np.linalg.det(M[:3, :3])))
    # closed form mirrors the error: scale(inv_closed(T)) == s, not 1/s
    assert scale(se3.inverse_np(T)) == pytest.approx(s, abs=1e-3)
    assert scale(np.linalg.inv(T)) == pytest.approx(1.0 / s, abs=1e-3)
    # the ref-re-anchor composition with a SHARED drift s on ref and
    # old_kf: without projection the drift compounds (s^2-class), with it
    # the result is exactly on SE(3)
    new_kf = np.eye(4, dtype=np.float32)
    new_kf[:3, :3] = ScipyRot.random(1, rng=4).as_matrix()[0]
    composed = T @ se3.inverse_np(T) @ new_kf
    assert scale(composed) == pytest.approx(s * s, rel=1e-3)
    fixed = se3.orthonormalize_np(T) @ se3.inverse_np(
        se3.orthonormalize_np(T)) @ new_kf
    assert scale(fixed) == pytest.approx(1.0, abs=1e-5)
