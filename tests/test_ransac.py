"""Tests for weighted Kabsch/Horn and batched RANSAC SE3."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.config import RansacConfig
from rgbdslam.geometry import se3
from rgbdslam.solvers.kabsch import weighted_rigid_transform
from rgbdslam.solvers.ransac_se3 import mahalanobis_sq, ransac_se3

CFG = RansacConfig()


def make_scene(rng, n=200, noise=0.0, rotvec=(0.05, -0.1, 0.2), t=(0.1, 0.05, -0.2)):
    """Camera-like 3D points (z in [0.5, 4]) and their transform under T21."""
    p1 = np.stack(
        [
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(-1.0, 1.0, n),
            rng.uniform(0.5, 4.0, n),
        ],
        axis=-1,
    ).astype(np.float32)
    R = ScipyRot.from_rotvec(rotvec).as_matrix().astype(np.float32)
    t = np.asarray(t, dtype=np.float32)
    p2 = p1 @ R.T + t + rng.normal(scale=noise, size=(n, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return p1, p2, T


def test_kabsch_exact_recovery():
    rng = np.random.default_rng(0)
    p1, p2, T = make_scene(rng, n=50)
    w = np.ones(50, dtype=np.float32)
    T_est = np.asarray(weighted_rigid_transform(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    np.testing.assert_allclose(T_est, T, atol=1e-4)


def test_kabsch_weighted_ignores_zero_weight_outliers():
    rng = np.random.default_rng(1)
    p1, p2, T = make_scene(rng, n=60)
    p2_corrupt = p2.copy()
    p2_corrupt[:10] += 5.0  # gross outliers
    w = np.ones(60, dtype=np.float32)
    w[:10] = 0.0
    T_est = np.asarray(
        weighted_rigid_transform(jnp.asarray(p1), jnp.asarray(p2_corrupt), jnp.asarray(w))
    )
    np.testing.assert_allclose(T_est, T, atol=1e-4)


def test_kabsch_batched():
    rng = np.random.default_rng(2)
    p1s, p2s, Ts = [], [], []
    for i in range(8):
        p1, p2, T = make_scene(rng, n=20, rotvec=rng.normal(scale=0.3, size=3))
        p1s.append(p1), p2s.append(p2), Ts.append(T)
    T_est = np.asarray(
        weighted_rigid_transform(
            jnp.asarray(np.stack(p1s)), jnp.asarray(np.stack(p2s)),
            jnp.ones((8, 20), jnp.float32),
        )
    )
    np.testing.assert_allclose(T_est, np.stack(Ts), atol=2e-4)


def test_kabsch_degenerate_returns_identity():
    p = jnp.zeros((4, 3))
    T = np.asarray(weighted_rigid_transform(p, p, jnp.zeros((4,))))
    np.testing.assert_allclose(T, np.eye(4), atol=1e-6)


def test_mahalanobis_zero_for_exact_transform():
    rng = np.random.default_rng(3)
    p1, p2, T = make_scene(rng, n=100)
    m2 = np.asarray(mahalanobis_sq(jnp.asarray(T), jnp.asarray(p1), jnp.asarray(p2), CFG))
    assert m2.shape == (100,)
    assert m2.max() < 1e-3


def test_mahalanobis_scales_with_depth():
    """Same metric error is less significant at larger depth (z^2 noise)."""
    T = jnp.eye(4)
    p_near = jnp.array([[0.0, 0.0, 0.7]])
    p_far = jnp.array([[0.0, 0.0, 3.5]])
    dz = jnp.array([[0.0, 0.0, 0.05]])
    m_near = float(mahalanobis_sq(T, p_near, p_near + dz, CFG)[0])
    m_far = float(mahalanobis_sq(T, p_far, p_far + dz, CFG)[0])
    assert m_near > m_far * 10


def test_ransac_recovers_transform_with_outliers():
    rng = np.random.default_rng(4)
    n = 256
    p1, p2, T = make_scene(rng, n=n, noise=0.003)
    # corrupt 40% with gross outliers
    n_out = int(0.4 * n)
    out_idx = rng.choice(n, n_out, replace=False)
    p2c = p2.copy()
    p2c[out_idx] = rng.uniform([-1.5, -1, 0.5], [1.5, 1, 4], size=(n_out, 3)).astype(np.float32)
    w = (1.0 / (p1[:, 2] * p2c[:, 2])).astype(np.float32)
    valid = np.ones(n, dtype=bool)

    res = ransac_se3(
        jnp.asarray(p1), jnp.asarray(p2c), jnp.asarray(w), jnp.asarray(valid),
        jax.random.PRNGKey(0), CFG,
    )
    assert bool(res.success)
    assert int(res.num_inliers) > 0.5 * n
    T_est = np.asarray(res.T21)
    # rotation error
    dR = T_est[:3, :3].T @ T[:3, :3]
    ang = np.degrees(np.arccos(np.clip(0.5 * (np.trace(dR) - 1), -1, 1)))
    assert ang < 0.5, f"rotation error {ang} deg"
    assert np.linalg.norm(T_est[:3, 3] - T[:3, 3]) < 0.02
    # inliers exclude most corrupted matches
    inl = np.asarray(res.inliers)
    assert inl[out_idx].mean() < 0.1


def test_ransac_identity_fallback():
    """Static scene (T = I) with small noise: hypothesis 0 = identity wins or
    ties; result must be near-identity and successful
    (Solver/SolverSE3.cpp:105-117 semantics)."""
    rng = np.random.default_rng(5)
    p1, p2, T = make_scene(rng, n=128, noise=0.002, rotvec=(0, 0, 0), t=(0, 0, 0))
    w = np.ones(128, dtype=np.float32)
    res = ransac_se3(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
        jnp.ones(128, dtype=bool), jax.random.PRNGKey(1), CFG,
    )
    assert bool(res.success)
    assert float(se3.translation_norm(res.T21)) < 0.01
    assert float(se3.rotation_angle(res.T21)) < 0.01


def test_ransac_fails_without_structure():
    """Pure-noise correspondences must not produce a confident estimate."""
    rng = np.random.default_rng(6)
    p1 = rng.uniform([-1, -1, 0.5], [1, 1, 4], size=(64, 3)).astype(np.float32)
    p2 = rng.uniform([-1, -1, 0.5], [1, 1, 4], size=(64, 3)).astype(np.float32)
    w = np.ones(64, dtype=np.float32)
    res = ransac_se3(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
        jnp.ones(64, dtype=bool), jax.random.PRNGKey(2), CFG,
    )
    assert int(res.num_inliers) < 25


def test_ransac_all_invalid():
    p = jnp.zeros((32, 3))
    res = ransac_se3(
        p, p, jnp.zeros((32,)), jnp.zeros((32,), dtype=bool),
        jax.random.PRNGKey(3), CFG,
    )
    assert not bool(res.success)
    assert int(res.num_inliers.sum()) == 0 or not bool(res.success)


def test_error_model_variants():
    """PUT-style error models (Solver/Ransac.h:15-19) all recover the
    transform on clean-but-outlier-contaminated data."""
    from rgbdslam.geometry.camera import SYNTHETIC

    rng = np.random.default_rng(7)
    n = 128
    p1, p2, T = make_scene(rng, n=n, noise=0.002)
    out_idx = rng.choice(n, 40, replace=False)
    p2c = p2.copy()
    p2c[out_idx] += rng.normal(scale=1.0, size=(40, 3)).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    valid = jnp.ones(n, dtype=bool)

    for model in ["euclidean", "adaptive_euclidean", "reprojection", "both"]:
        cfg = RansacConfig(error_model=model)
        res = ransac_se3(
            jnp.asarray(p1), jnp.asarray(p2c), jnp.asarray(w), valid,
            jax.random.PRNGKey(10), cfg, SYNTHETIC,
        )
        assert bool(res.success), model
        T_est = np.asarray(res.T21)
        dR = T_est[:3, :3].T @ T[:3, :3]
        ang = np.degrees(np.arccos(np.clip(0.5 * (np.trace(dR) - 1), -1, 1)))
        assert ang < 1.0, (model, ang)
        assert np.linalg.norm(T_est[:3, 3] - T[:3, 3]) < 0.05, model


def test_mahalanobis_refine_beats_scalar_fit_under_depth_noise():
    """Anisotropic polish: with z^2-scaled depth noise at 2.5-4 m, the
    whitened GN recovers a noticeably better transform than the
    scalar-weighted fit alone."""
    rng = np.random.default_rng(11)
    n = 512
    p1, p2, T = make_scene(rng, n=n, noise=0.0, rotvec=(0.03, -0.05, 0.02),
                           t=(0.1, -0.05, 0.08))
    # push points deep and apply anisotropic (z-dominant) sensor noise
    p1[:, 2] += 1.5
    p2 = p1 @ T[:3, :3].T + T[:3, 3]
    for p in (p1, p2):
        p[:, 2] += rng.normal(size=n) * 0.01 * p[:, 2] ** 2
        p[:, :2] += rng.normal(size=(n, 2)) * 0.002
    w = (1.0 / (np.maximum(p1[:, 2], 0.1) * np.maximum(p2[:, 2], 0.1))).astype(np.float32)
    valid = jnp.ones(n, dtype=bool)

    def run(cfg):
        res = ransac_se3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w),
                         valid, jax.random.PRNGKey(4), cfg)
        dT = np.linalg.inv(np.asarray(res.T21)) @ T
        return float(se3.translation_norm(jnp.asarray(dT)))

    errs_plain, errs_aniso = [], []
    for seed in range(3):
        cfg_p = RansacConfig()
        cfg_a = RansacConfig(mahalanobis_refine=True)
        errs_plain.append(run(cfg_p))
        errs_aniso.append(run(cfg_a))
    assert np.mean(errs_aniso) < np.mean(errs_plain), (errs_aniso, errs_plain)
