"""Weighted rigid-transform fitting (Horn's quaternion method), batched.

Batched replacement for pcl::TransformationFromCorrespondences
(Solver/SolverSE3.cpp:161-179): given correspondences p1 -> p2 with weights,
find T21 minimizing sum w |R p1 + t - p2|^2.

Instead of an SVD (slow for huge batches of tiny matrices), we use Horn's closed-form quaternion formulation: the
optimal rotation is the dominant eigenvector of a symmetric 4x4 matrix built
from the weighted cross-covariance. The dominant eigenvector is extracted with
a fixed number of shifted power iterations — pure batched 4x4 matvecs that
vmap and fuse.
"""

from __future__ import annotations

import jax.numpy as jnp

from rgbdslam.geometry import se3


def _horn_quaternion(S: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """Dominant eigenvector (as quaternion (w,x,y,z)) of Horn's N matrix.

    S: (..., 3, 3) weighted cross-covariance sum_i w p1_i p2_i^T (centered).
    Returns (..., 4) unit quaternion rotating frame-1 vectors into frame-2.
    """
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]

    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], axis=-1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], axis=-1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], axis=-1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], axis=-1),
        ],
        axis=-2,
    )  # (..., 4, 4)

    # Shift so the target (largest algebraic) eigenvalue is also largest in
    # magnitude: Gershgorin row-sum bound.
    shift = jnp.sum(jnp.abs(N), axis=-1).max(axis=-1)  # (...,)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=N.dtype), N.shape)
    M = N + shift[..., None, None] * eye

    q = jnp.broadcast_to(
        jnp.array([1.0, 0.03, 0.02, 0.01], dtype=N.dtype), N.shape[:-2] + (4,)
    )
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    for _ in range(iters):
        q = (M @ q[..., None])[..., 0]
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-20)
    return q


def weighted_rigid_transform(
    p1: jnp.ndarray, p2: jnp.ndarray, w: jnp.ndarray, iters: int = 30
) -> jnp.ndarray:
    """Fit T21 (4x4) with p2 ~= R @ p1 + t, weighted least squares.

    p1, p2: (..., N, 3); w: (..., N) nonnegative. Zero-weight-sum inputs
    return identity.
    """
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    c1 = jnp.sum(wn[..., None] * p1, axis=-2)
    c2 = jnp.sum(wn[..., None] * p2, axis=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    # S = sum w q1 q2^T  (3x3)
    S = jnp.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    quat_wxyz = _horn_quaternion(S, iters)
    # our se3 util uses (x, y, z, w)
    q_xyzw = jnp.concatenate([quat_wxyz[..., 1:], quat_wxyz[..., :1]], axis=-1)
    R = se3.rotation_from_quat(q_xyzw)
    t = c2 - (R @ c1[..., None])[..., 0]
    T = se3.from_Rt(R, t)
    degenerate = (wsum[..., 0] <= 1e-12)[..., None, None]
    return jnp.where(degenerate, jnp.eye(4, dtype=T.dtype), T)


def weighted_similarity_transform(
    p1: jnp.ndarray, p2: jnp.ndarray, w: jnp.ndarray, iters: int = 30
) -> jnp.ndarray:
    """Fit Sim(3) S21 (4x4, [[s R, t], [0, 1]]) with p2 ~= s R p1 + t —
    the scale-aware Umeyama fit (the PUT Ransac's Eigen::umeyama analog,
    Solver/Ransac.cpp:210-245, which the reference always calls with
    scale pinned; here scale is free for cross-session map merging where
    depth-factor miscalibration makes the two maps' scales differ).

    Same Horn-quaternion rotation as weighted_rigid_transform; the optimal
    scale under it is s = sum w q2.(R q1) / sum w |q1|^2.
    """
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    c1 = jnp.sum(wn[..., None] * p1, axis=-2)
    c2 = jnp.sum(wn[..., None] * p2, axis=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    S = jnp.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    quat_wxyz = _horn_quaternion(S, iters)
    q_xyzw = jnp.concatenate([quat_wxyz[..., 1:], quat_wxyz[..., :1]], axis=-1)
    R = se3.rotation_from_quat(q_xyzw)
    rq1 = (R @ jnp.swapaxes(q1, -1, -2))  # (..., 3, N)
    num = jnp.einsum("...n,...in,...ni->...", wn, rq1, q2)
    den = jnp.einsum("...n,...ni,...ni->...", wn, q1, q1)
    s = num / jnp.maximum(den, 1e-12)
    s = jnp.maximum(s, 1e-6)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    T = se3.from_Rt(s[..., None, None] * R, t)
    degenerate = (wsum[..., 0] <= 1e-12)[..., None, None]
    return jnp.where(degenerate, jnp.eye(4, dtype=T.dtype), T)
