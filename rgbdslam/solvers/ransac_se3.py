"""Batched 3D-3D RANSAC rigid registration with the RGB-D Mahalanobis noise
model — the batched RansacSE3 (Solver/SolverSE3.cpp).

Re-design as one array program (SURVEY.md §7 layer 5): the reference runs up
to 200 sequential iterations, each sampling 4 matches, fitting a weighted
rigid transform, and refining until the inlier set stabilizes, with
early-exit heuristics (Solver/SolverSE3.cpp:54-103). Under XLA we instead:

1. draw H hypotheses at once (categorical sampling over the valid-match mask),
2. fit all H transforms in parallel (vmapped weighted Horn/Kabsch),
3. score all H x N Mahalanobis residuals in one fused contraction,
4. pick the best hypothesis by (inlier count, error) lexicographic rank,
5. run a fixed number of masked full-inlier refinement re-fits
   (the reference's refine-until-stable loop, Solver/SolverSE3.cpp:61-84).

Hypothesis slot 0 is pinned to the identity transform, subsuming the
reference's identity fallback (Solver/SolverSE3.cpp:105-117).

Noise model (Solver/SolverSE3.cpp:216-297, Khoshelham): per-axis covariance
diag(raster_cov_x * z, raster_cov_y * z, (c * z^2)^2). Two deliberate
divergences from the reference code, documented:
- the reference's depthCovariance caches the FIRST depth's covariance in a
  C++ function-local static (Solver/SolverSE3.cpp:282-287) — we compute it
  per point as intended;
- the reference conjugates the covariance with R^T Σ R
  (Solver/SolverSE3.cpp:264); the correct frame change is R Σ R^T, which we
  use.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from rgbdslam.config import RansacConfig
from rgbdslam.solvers.kabsch import weighted_rigid_transform
from rgbdslam.utils import pytree


@pytree.dataclass
class RansacResult:
    T21: jnp.ndarray          # (4, 4) best transform frame1 -> frame2 coords
    inliers: jnp.ndarray      # (N,) bool final inlier mask
    num_inliers: jnp.ndarray  # () int32
    rmse: jnp.ndarray         # () f32 sqrt(mean mahalanobis^2) over inliers
    success: jnp.ndarray      # () bool num_inliers >= min_inliers


def _sigma_diag(z: jnp.ndarray, cfg: RansacConfig) -> jnp.ndarray:
    """Per-point diagonal covariance (..., 3) of the RGB-D noise model."""
    rx = 3.0 * math.tan(math.radians(cfg.cam_angle_x) / cfg.cam_resol_x)
    ry = 3.0 * math.tan(math.radians(cfg.cam_angle_y) / cfg.cam_resol_y)
    raster_cov_x = rx * rx
    raster_cov_y = ry * ry
    sz = cfg.depth_std_factor * z * z
    return jnp.stack([raster_cov_x * z, raster_cov_y * z, sz * sz], axis=-1)


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([co_a, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([co_c, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def mahalanobis_sq(
    T21: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray, cfg: RansacConfig
) -> jnp.ndarray:
    """Squared Mahalanobis distance of each correspondence under T21.

    T21: (..., 4, 4); p1, p2: (N, 3) camera-frame points.
    Returns (..., N). Mirrors errorFunction2 (Solver/SolverSE3.cpp:216-280).

    Formulated on six symmetric-covariance scalar planes instead of
    (..., N, 3, 3) tensors: with H hypotheses the tensor form materializes
    ~100 MB of covariance/adjugate intermediates in HBM per call; the plane
    form is ~20 (H, N) arrays that XLA keeps in one fusion.
    """
    R = T21[..., :3, :3]
    t = T21[..., :3, 3]
    mu1_in_2 = jnp.einsum("...ij,nj->...ni", R, p1) + t[..., None, :]
    delta = mu1_in_2 - p2              # (..., N, 3)
    d1, d2, d3 = delta[..., 0], delta[..., 1], delta[..., 2]

    s1 = _sigma_diag(p1[:, 2], cfg)    # (N, 3) diag of Sigma_1
    s2 = _sigma_diag(p2[:, 2], cfg)

    # C = R diag(s1) R^T + diag(s2): six unique entries as (..., N) planes,
    # C_ij = sum_k R_ik R_jk s1_k (+ s2_i on the diagonal)
    def centry(i, j):
        c = sum((R[..., i, k] * R[..., j, k])[..., None] * s1[:, k]
                for k in range(3))
        if i == j:
            c = c + s2[:, i]
        return c                        # (..., N)

    a, b, c = centry(0, 0), centry(0, 1), centry(0, 2)
    d, e, f = centry(1, 1), centry(1, 2), centry(2, 2)

    # m2 = delta^T adj(C) delta / det(C), symmetric closed form
    A11 = d * f - e * e
    A12 = c * e - b * f
    A13 = b * e - c * d
    A22 = a * f - c * c
    A23 = b * c - a * e
    A33 = a * d - b * b
    det = a * A11 + b * A12 + c * A13
    quad = (A11 * d1 * d1 + A22 * d2 * d2 + A33 * d3 * d3
            + 2.0 * (A12 * d1 * d2 + A13 * d1 * d3 + A23 * d2 * d3))
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return jnp.maximum(quad * inv_det, 0.0)


def _score(
    T: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: RansacConfig,
    cam=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Inlier mask, count and error for transforms T (..., 4, 4).

    Dispatches on cfg.error_model (static) — the PUT-style Ransac's selectable
    error models (Solver/Ransac.h:15-19, Solver/Ransac.cpp:247-427) unified
    into the batched scorer.
    """
    model = cfg.error_model
    if model == "mahalanobis":
        m2 = mahalanobis_sq(T, p1, p2, cfg)  # (..., N)
        th = cfg.max_mahalanobis * cfg.max_mahalanobis
        inl = (m2 <= th) & valid
        err = m2
    else:
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        p1_in_2 = jnp.einsum("...ij,nj->...ni", R, p1) + t[..., None, :]
        delta = jnp.linalg.norm(p1_in_2 - p2, axis=-1)  # (..., N)
        if model == "euclidean":
            inl_e = delta <= cfg.inlier_threshold_m
        elif model == "adaptive_euclidean":
            z_mean = 0.5 * (p1[:, 2] + p2[:, 2])
            th_a = cfg.inlier_threshold_m + cfg.adaptive_depth_coeff * z_mean * z_mean
            inl_e = delta <= th_a
        elif model in ("reprojection", "both"):
            if cam is None:
                raise ValueError(f"error_model={model!r} requires a camera")
            z = jnp.maximum(p1_in_2[..., 2], 1e-6)
            u = cam.fx * p1_in_2[..., 0] / z + cam.cx
            v = cam.fy * p1_in_2[..., 1] / z + cam.cy
            z2 = jnp.maximum(p2[:, 2], 1e-6)
            u2 = cam.fx * p2[:, 0] / z2 + cam.cx
            v2 = cam.fy * p2[:, 1] / z2 + cam.cy
            px_err = jnp.sqrt((u - u2) ** 2 + (v - v2) ** 2)
            inl_r = px_err <= cfg.reproj_threshold_px
            if model == "both":
                inl_e = inl_r & (delta <= cfg.inlier_threshold_m)
            else:
                inl_e = inl_r
        else:
            raise ValueError(f"unknown error_model {model!r}")
        inl = inl_e & valid
        err = delta * delta

    cnt = jnp.sum(inl, axis=-1)
    err_sum = jnp.sum(jnp.where(inl, err, 0.0), axis=-1)
    # meanError semantics (Solver/SolverSE3.cpp:206-213): <3 inliers -> huge
    rmse = jnp.where(
        cnt >= 3, jnp.sqrt(err_sum / jnp.maximum(cnt, 1)), 1e9
    )
    return inl, cnt, rmse


def _chol3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 Cholesky (lower), for whitening residuals."""
    a11 = jnp.sqrt(jnp.maximum(A[..., 0, 0], 1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    a22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 * l21, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / a22
    a33 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l31 * l31 - l32 * l32, 1e-20))
    zero = jnp.zeros_like(a11)
    return jnp.stack(
        [
            jnp.stack([a11, zero, zero], axis=-1),
            jnp.stack([l21, a22, zero], axis=-1),
            jnp.stack([l31, l32, a33], axis=-1),
        ],
        axis=-2,
    )


def refine_mahalanobis(
    T0: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    inliers: jnp.ndarray,
    cfg: RansacConfig,
    iterations: int = 5,
) -> jnp.ndarray:
    """Anisotropic Gauss-Newton polish: minimize the *Mahalanobis* cost the
    scorer uses, instead of the scalar-weighted least squares of the Kabsch
    fit.

    Beyond the reference: its estimator (pcl TransformationFromCorrespondences,
    Solver/SolverSE3.cpp:161-179) weights points by the scalar 1/(z1*z2), so
    the z-dominant RGB-D depth noise (sigma_z/sigma_xy ~ 20 beyond 2.5 m)
    leaks into the lateral/rotation estimate. Whitening each residual with
    the sensor covariance (the same Khoshelham model the inlier gate assumes)
    keeps the precise image-plane information at full weight.
    """
    from rgbdslam.geometry import se3 as _se3

    s1 = _sigma_diag(p1[:, 2], cfg)
    s2 = _sigma_diag(p2[:, 2], cfg)
    eye = jnp.eye(3, dtype=T0.dtype)
    cov1 = s1[:, :, None] * eye
    cov2 = s2[:, :, None] * eye
    wm = inliers.astype(T0.dtype)

    def gn(_, T):
        R = T[:3, :3]
        t = T[:3, 3]
        q = p1 @ R.T + t
        delta = q - p2                                   # (N, 3)
        cov = jnp.einsum("ij,njk,lk->nil", R, cov1, R) + cov2
        # whitener W = L^-1 with Sigma = L L^T  ->  |W delta|^2 = mahal^2
        L = _chol3(cov)
        Wd = jax.scipy.linalg.solve_triangular(L, delta[..., None], lower=True)[..., 0]
        # Jacobian of delta wrt left-increment xi: [I | -hat(q)], whitened
        Jr = jnp.concatenate(
            [jnp.broadcast_to(eye, (q.shape[0], 3, 3)), -_se3.hat(q)], axis=-1
        )                                                 # (N, 3, 6)
        WJ = jax.scipy.linalg.solve_triangular(L, Jr, lower=True)
        H = jnp.einsum("nij,nik,n->jk", WJ, WJ, wm) + 1e-6 * jnp.eye(6, dtype=T.dtype)
        g = jnp.einsum("nij,ni,n->j", WJ, Wd, wm)
        xi = -jnp.linalg.solve(H, g)
        return _se3.exp(xi) @ T

    T_out = jax.lax.fori_loop(0, iterations, gn, T0)
    ok = jnp.isfinite(T_out).all() & (jnp.sum(wm) >= 3)
    return jnp.where(ok, T_out, T0)


@functools.partial(jax.jit, static_argnums=(5, 6))
def ransac_se3(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    w: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    cfg: RansacConfig = RansacConfig(),
    cam=None,
) -> RansacResult:
    """Estimate T21 with p2 ~= T21 * p1 from masked correspondences.

    Args:
      p1, p2: (N, 3) matched camera-frame points (frame1, frame2).
      w: (N,) fit weights — the reference uses 1/(z1*z2)
         (Solver/SolverSE3.cpp:174); zero for invalid slots.
      valid: (N,) bool usable correspondences.
      key: PRNG key (replaces the reference's time-seeded rand(),
         System/Random.cpp:7-20 — runs here are reproducible).
      cfg: static RansacConfig.
    """
    n = p1.shape[0]
    H, S = cfg.num_hypotheses, cfg.sample_size

    # (H, S) indices of sampled matches, uniform over the VALID slots:
    # compact the valid indices and draw H*S uniform ints — a categorical
    # over N logits materializes an (H*S, N) gumbel field (~1M RNG draws
    # per call) for the same distribution; this form draws H*S.
    # Degenerate/duplicate draws simply produce low-scoring hypotheses; if
    # nothing is valid, draws hit slot 0 and `success` below is False anyway.
    any_valid = jnp.any(valid)
    pos = jnp.cumsum(valid) - 1
    cand = jnp.zeros((n,), jnp.int32).at[
        jnp.where(valid, pos, n)
    ].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    draws = jax.random.randint(key, (H, S), 0, n_valid)
    idx = cand[draws]

    sp1 = p1[idx]                      # (H, S, 3)
    sp2 = p2[idx]
    sw = w[idx] * valid[idx]           # (H, S)
    T_h = weighted_rigid_transform(sp1, sp2, sw)  # (H, 4, 4)
    # hypothesis 0 = identity (identity fallback, Solver/SolverSE3.cpp:105-117)
    T_h = T_h.at[0].set(jnp.eye(4, dtype=T_h.dtype))

    _inl_h, cnt_h, rmse_h = _score(T_h, p1, p2, valid, cfg, cam)
    # lexicographic best: max inliers, then min error
    rank = cnt_h.astype(jnp.float32) * 1e4 - jnp.minimum(rmse_h, 9e3)
    best = jnp.argmax(rank)
    T_best = T_h[best]
    # the winner's inlier mask (only the winner's is ever needed)
    inl_b, cnt_b, rmse_b = _score(T_best, p1, p2, valid, cfg, cam)

    # masked refinement re-fits on the full inlier set
    # (Solver/SolverSE3.cpp:61-84 refine-until-stable, fixed-trip here)
    def refine_step(carry, _):
        T, _inl, _cnt, _rmse = carry
        inl, cnt, rmse = _score(T, p1, p2, valid, cfg, cam)
        w_fit = w * inl.astype(w.dtype)
        T_new = weighted_rigid_transform(p1, p2, w_fit)
        inl2, cnt2, rmse2 = _score(T_new, p1, p2, valid, cfg, cam)
        # keep refinement only if it does not lose inliers (reference keeps
        # refits with >= inliers and <= error, Solver/SolverSE3.cpp:72)
        better = (cnt2 >= cnt) & (rmse2 <= rmse)
        T_keep = jnp.where(better, T_new, T)
        return (T_keep, jnp.where(better, inl2, inl), jnp.where(better, cnt2, cnt),
                jnp.where(better, rmse2, rmse)), None

    init = (T_best, inl_b, cnt_b, rmse_b)
    (T_fin, inl_fin, cnt_fin, rmse_fin), _ = jax.lax.scan(
        refine_step, init, None, length=cfg.refine_iters
    )

    if cfg.mahalanobis_refine:
        T_m = refine_mahalanobis(T_fin, p1, p2, inl_fin, cfg,
                                 cfg.mahalanobis_refine_iters)
        inl_m, cnt_m, rmse_m = _score(T_m, p1, p2, valid, cfg, cam)
        better = (cnt_m >= cnt_fin) & (rmse_m <= rmse_fin)
        T_fin = jnp.where(better, T_m, T_fin)
        inl_fin = jnp.where(better, inl_m, inl_fin)
        cnt_fin = jnp.where(better, cnt_m, cnt_fin)
        rmse_fin = jnp.where(better, rmse_m, rmse_fin)

    success = (cnt_fin >= cfg.min_inliers) & any_valid
    return RansacResult(
        T21=T_fin,
        inliers=inl_fin & success,
        num_inliers=cnt_fin.astype(jnp.int32),
        rmse=rmse_fin,
        success=success,
    )
