"""Local bundle adjustment tests on synthetic multi-view problems."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera
from rgbdslam.solvers.ba import BAProblem, local_ba

CAM = Camera(300.0, 300.0, 159.5, 119.5, width=320, height=240)


def make_problem(rng, K=6, L=64, M=6, pose_noise=0.02, lm_noise=0.05,
                 px_noise=0.3):
    """Cameras on an arc looking at a landmark cloud; noisy initialization."""
    Tcw_gt, Tcw0 = [], []
    for k in range(K):
        a = 0.3 * k
        eye = np.array([1.5 * np.sin(a), 0.1 * k, -2.5 + 0.2 * k])
        Rwc = ScipyRot.from_euler("yx", [0.2 * np.sin(a), 0.05 * k]).as_matrix()
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = eye
        T = np.linalg.inv(Twc).astype(np.float32)
        Tcw_gt.append(T)
        noise = np.asarray(se3.exp(jnp.asarray(
            (rng.normal(scale=pose_noise, size=6)).astype(np.float32))))
        Tcw0.append((noise @ T).astype(np.float32) if k > 0 else T)

    Xw_gt = np.stack([
        rng.uniform(-1.5, 1.5, L), rng.uniform(-1.0, 1.0, L),
        rng.uniform(0.5, 2.0, L),
    ], axis=-1).astype(np.float32)
    Xw0 = Xw_gt + rng.normal(scale=lm_noise, size=(L, 3)).astype(np.float32)

    obs_kf = np.zeros((L, M), np.int32)
    obs_uv = np.zeros((L, M, 2), np.float32)
    obs_z = np.zeros((L, M), np.float32)
    obs_valid = np.zeros((L, M), bool)
    for l in range(L):
        kfs = rng.choice(K, size=min(M, K), replace=False)
        for m, k in enumerate(kfs):
            Xc = Tcw_gt[k][:3, :3] @ Xw_gt[l] + Tcw_gt[k][:3, 3]
            if Xc[2] < 0.2:
                continue
            u = CAM.fx * Xc[0] / Xc[2] + CAM.cx
            v = CAM.fy * Xc[1] / Xc[2] + CAM.cy
            if not (0 <= u < CAM.width and 0 <= v < CAM.height):
                continue
            obs_kf[l, m] = k
            obs_uv[l, m] = [u + rng.normal(scale=px_noise),
                            v + rng.normal(scale=px_noise)]
            # RGB-D depth measurement with Khoshelham-scaled noise
            obs_z[l, m] = Xc[2] + rng.normal(scale=0.01 * Xc[2] ** 2) * (px_noise > 0)
            obs_valid[l, m] = True

    problem = BAProblem(
        Tcw=jnp.asarray(np.stack(Tcw0)),
        Xw=jnp.asarray(Xw0),
        lm_valid=jnp.ones((L,), bool),
        obs_kf=jnp.asarray(obs_kf),
        obs_uv=jnp.asarray(obs_uv),
        obs_valid=jnp.asarray(obs_valid),
        obs_z=jnp.asarray(obs_z),
    )
    return problem, np.stack(Tcw_gt), Xw_gt


def pose_errs(Tcw, Tcw_gt):
    errs = []
    for a, b in zip(Tcw, Tcw_gt):
        d = np.linalg.inv(a) @ b
        errs.append(float(se3.translation_norm(jnp.asarray(d))))
    return np.asarray(errs)


def test_ba_reduces_pose_and_landmark_error():
    rng = np.random.default_rng(0)
    problem, Tcw_gt, Xw_gt = make_problem(rng)
    fixed = jnp.zeros((6,), bool).at[0].set(True)

    Tcw_opt, Xw_opt, cost = local_ba(CAM, problem, fixed, iterations=8)

    e0 = pose_errs(np.asarray(problem.Tcw), Tcw_gt)
    e1 = pose_errs(np.asarray(Tcw_opt), Tcw_gt)
    assert e1[1:].mean() < 0.3 * e0[1:].mean(), (e0.mean(), e1.mean())

    # landmark 3-D error is geometry-limited (short baselines + pixel noise
    # at 2-3 m depth): expect improvement, not collapse
    l0 = np.linalg.norm(np.asarray(problem.Xw) - Xw_gt, axis=-1).mean()
    l1 = np.linalg.norm(np.asarray(Xw_opt) - Xw_gt, axis=-1).mean()
    assert l1 < 0.8 * l0, (l0, l1)
    assert np.isfinite(float(cost))


def test_ba_fixed_kf_does_not_move():
    rng = np.random.default_rng(1)
    problem, Tcw_gt, Xw_gt = make_problem(rng)
    fixed = jnp.zeros((6,), bool).at[0].set(True)
    Tcw_opt, _, _ = local_ba(CAM, problem, fixed, iterations=5)
    np.testing.assert_allclose(
        np.asarray(Tcw_opt)[0], np.asarray(problem.Tcw)[0], atol=1e-6
    )


def test_ba_exact_data_stays_put():
    """Noise-free observations + ground-truth init: BA must not perturb."""
    rng = np.random.default_rng(2)
    problem, Tcw_gt, Xw_gt = make_problem(
        rng, pose_noise=0.0, lm_noise=0.0, px_noise=0.0
    )
    fixed = jnp.zeros((6,), bool).at[0].set(True)
    Tcw_opt, Xw_opt, cost = local_ba(CAM, problem, fixed, iterations=3)
    e = pose_errs(np.asarray(Tcw_opt), Tcw_gt)
    assert e.max() < 1e-4
    assert float(cost) < 1e-4


def test_ba_ignores_invalid_observations():
    rng = np.random.default_rng(3)
    problem, Tcw_gt, Xw_gt = make_problem(rng)
    # corrupt some observations but mark them invalid -> same result
    bad_uv = np.asarray(problem.obs_uv).copy()
    bad_valid = np.asarray(problem.obs_valid).copy()
    bad_uv[:10] += 500.0
    bad_valid[:10] = False
    p2 = problem._replace(obs_uv=jnp.asarray(bad_uv),
                          obs_valid=jnp.asarray(bad_valid))
    fixed = jnp.zeros((6,), bool).at[0].set(True)
    T1, X1, _ = local_ba(CAM, problem._replace(
        obs_valid=jnp.asarray(bad_valid)), fixed, iterations=5)
    T2, X2, _ = local_ba(CAM, p2, fixed, iterations=5)
    np.testing.assert_allclose(np.asarray(T1), np.asarray(T2), atol=1e-5)


def test_ba_padded_keyframes_stay_identity():
    """Global-BA bucketing: extra padded keyframes (fixed, no observations)
    must not move and must not disturb the real solution."""
    rng = np.random.default_rng(5)
    problem, Tcw_gt, Xw_gt = make_problem(rng, K=6)
    K, pad_k = 6, 8
    Tcw_pad = jnp.concatenate(
        [problem.Tcw,
         jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (pad_k - K, 4, 4))]
    )
    padded = problem._replace(Tcw=Tcw_pad)
    fixed = np.zeros((pad_k,), bool)
    fixed[0] = True
    fixed[K:] = True
    Tcw_opt, Xw_opt, _ = local_ba(CAM, padded, jnp.asarray(fixed), 6)
    np.testing.assert_allclose(
        np.asarray(Tcw_opt[K:]),
        np.broadcast_to(np.eye(4, dtype=np.float32), (pad_k - K, 4, 4)),
        atol=1e-6)

    fixed_ref = jnp.zeros((K,), bool).at[0].set(True)
    Tcw_ref, Xw_ref, _ = local_ba(CAM, problem, fixed_ref, 6)
    np.testing.assert_allclose(np.asarray(Tcw_opt[:K]), np.asarray(Tcw_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(Xw_opt), np.asarray(Xw_ref),
                               atol=1e-5)


def test_ba_edge_factors_constrain_poses():
    """Joint BA: high-weight relative-pose edge factors pull the solution to
    the edge-consistent trajectory even against noisy landmark terms."""
    import jax

    from rgbdslam.solvers.ba import BAEdges

    rng = np.random.default_rng(9)
    problem, Tcw_gt, Xw_gt = make_problem(rng, K=6, px_noise=1.5,
                                          lm_noise=0.1, pose_noise=0.05)
    K = 6
    # edges: ground-truth consecutive relative poses in the Twc convention
    # Z = Twc_a^-1 Twc_b (a = i+1, b = i)
    ea, eb, eZ = [], [], []
    for i in range(K - 1):
        a, b = i + 1, i
        Twc_a = np.linalg.inv(Tcw_gt[a])
        Twc_b = np.linalg.inv(Tcw_gt[b])
        ea.append(a)
        eb.append(b)
        eZ.append(np.linalg.inv(Twc_a) @ Twc_b)
    pad = 8
    a = np.zeros((pad,), np.int32); a[: K - 1] = ea
    b = np.zeros((pad,), np.int32); b[: K - 1] = eb
    Z = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
    Z[: K - 1] = np.stack(eZ)
    w = np.zeros((pad,), np.float32); w[: K - 1] = 1e5
    edges = BAEdges(a=jnp.asarray(a), b=jnp.asarray(b), Z=jnp.asarray(Z),
                    w=jnp.asarray(w))

    fixed = jnp.zeros((K,), bool).at[0].set(True)
    T_lm, _, _ = local_ba(CAM, problem, fixed, 8)
    T_joint, _, _ = local_ba(CAM, problem, fixed, 8, edges=edges,
                             edge_huber=1.0)
    err_lm = pose_errs(np.asarray(T_lm), Tcw_gt).mean()
    err_joint = pose_errs(np.asarray(T_joint), Tcw_gt).mean()
    assert err_joint < err_lm
    assert err_joint < 0.01, f"joint BA err {err_joint}"
