"""SE(3) / SO(3) / quaternion math as pure jax.numpy functions.

Array-program replacement for the reference's System/Converter.{h,cpp} (cv::Mat /
Eigen / g2o conversions) and the SE(3) manipulation scattered through g2o.
Everything is batched-friendly (leading batch dims via vmap) and uses float32
homogeneous 4x4 matrices with the reference's `Tcw` (world->camera) convention
(Core/Frame.cpp:124-177).

Tangent-space convention: xi = [rho, phi] (translation part first, rotation
part last), T = exp(hat(xi)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues' formula with small-angle Taylor fallback. (...,3)->(...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    # sin(t)/t and (1-cos t)/t^2 with Taylor fallback
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(phi)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map of SO(3): (..., 3, 3) -> (..., 3). Handles angles near 0 and pi.

    The generic branch normalizes by |w| = 2 sin(theta) measured directly from
    the skew part — computing sin(arccos(trace)) instead would amplify f32
    trace noise by 1/sin(theta) (~1000x near pi).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = vee(R - jnp.swapaxes(R, -1, -2))      # 2 sin(theta) * axis
    w_norm = jnp.linalg.norm(w, axis=-1)      # 2 sin(theta), well-conditioned
    theta = jnp.arctan2(w_norm, trace - 1.0)  # = atan2(2 sin t, 2 cos t)
    small = w_norm < 1e-6
    # axis*theta = w * theta/|w|; theta/|w| -> 1/2 + theta^2/12 as theta -> 0
    scale = jnp.where(
        small, 0.5 + theta * theta / 12.0,
        theta / jnp.where(small, 1.0, w_norm),
    )
    generic = w * scale[..., None]
    # Near pi: at theta = pi, R + I = 2 a a^T (+ O(pi - theta) terms), so every
    # nonzero column of (R + I) is parallel to the axis. Take the column with
    # the largest diagonal entry (|a_l| maximal) and normalize — this carries
    # consistent *relative* signs for all components, unlike per-component
    # sqrt-with-sign-fixing. The overall axis sign is ambiguous at exactly pi;
    # when w = vee(R - R^T) is usable we align to it for continuity.
    B = R + jnp.eye(3, dtype=R.dtype)
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    largest = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(
        B, largest[..., None, None].repeat(3, axis=-2), axis=-1
    )[..., :, 0]
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), 1e-12)
    # align sign with w where w is informative
    w_dot = jnp.sum(axis * w, axis=-1, keepdims=True)
    axis = jnp.where(w_dot < 0, -axis, axis)
    # crossover: the w-based axis degrades as |w| -> f32 noise, the column
    # method as (pi - theta) grows; they balance around pi - theta ~ 3e-4
    near_pi = theta > (jnp.pi - 3e-4)
    near = axis * theta[..., None]
    return jnp.where(near_pi[..., None], near, generic)


def _so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J of SO(3) such that exp(hat(J @ rho)) relates translations."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    W = hat(phi)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * WW


def _so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    half = 0.5 * theta
    cot = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-20)) / jnp.maximum(theta2, _EPS * _EPS))
    W = hat(phi)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye - 0.5 * W + cot[..., None, None] * WW


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential map: (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_Rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log map: (..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    rho = (_so3_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from rotation (...,3,3) and translation (...,3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Rigid-transform inverse (exploits orthogonality; no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return from_Rt(Rt, -(Rt @ t[..., None])[..., 0])


def inverse_np(T):
    """Host-numpy twin of `inverse` for (..., 4, 4) pose stacks: [R^T |
    -R^T t]. The host orchestrator composes/inverts poses constantly;
    np.linalg.inv on 4x4 stacks was the single largest host-CPU item in the
    full-SLAM profile (0.17 s of the 0.40 s B=32 host budget — LAPACK
    per-matrix dispatch), and the closed form is also what the DEVICE
    already uses, so host/device semantics agree exactly."""
    import numpy as _np

    T = _np.asarray(T)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = _np.swapaxes(R, -1, -2)
    out = _np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -_np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def orthonormalize_np(T):
    """Project the rotation block of (..., 4, 4) host poses back onto
    SO(3) (polar projection via SVD, det-corrected), preserving the
    translation. Returns float32.

    Why this exists: chained f32 pose composes (Tcw = T21 @ Tcw, one per
    frame) drift the rotation's scale by ~1e-7 per product. `inverse_np`'s
    closed form [R^T | -R^T t] then MIRRORS that scale error instead of
    inverting it (for R' = s*R the true inverse carries 1/s, the closed
    form carries s), so every loop-closure re-anchor
    (Tracker.apply_correction: ref' = ref @ inverse_np(old_kf) @ new_kf)
    feeds the error back with the wrong sign — measured on the 600-frame
    tour, the log-scale error TRIPLES per loop closure and the map
    explodes super-exponentially after ~14 closures. One 3x3 SVD per
    frame (a few microseconds on host) keeps every live pose exactly on
    SE(3), which is the invariant the closed-form inverse needs."""
    import numpy as _np

    T = _np.asarray(T)
    R = T[..., :3, :3].astype(_np.float64)
    U, _, Vt = _np.linalg.svd(R)
    d = _np.sign(_np.linalg.det(U @ Vt))
    U = U.copy()
    U[..., :, 2] *= _np.asarray(d)[..., None]
    out = T.astype(_np.float32).copy()
    out[..., :3, :3] = (U @ Vt).astype(_np.float32)
    return out


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def transform_points(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (...,4,4) to points (..., N, 3) -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def translation_norm(T: jnp.ndarray) -> jnp.ndarray:
    """|t| — the reference's `tnorm` (System/Tracking.cpp:201-205)."""
    return jnp.linalg.norm(T[..., :3, 3], axis=-1)


def rotation_angle(T: jnp.ndarray) -> jnp.ndarray:
    """acos((tr(R)-1)/2) — the reference's `rnorm` (System/Tracking.cpp:207-211)."""
    tr = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return jnp.arccos(jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0))


# ---------------------------------------------------------------------------
# Autodiff-safe log maps (for Gauss-Newton residuals)
#
# The general-purpose so3_log/log above handle angles up to pi but their
# arccos/argmax branches have unbounded or NaN derivatives at r -> 0 — exactly
# where pose-graph residuals live. These variants are smooth near identity
# (valid for |theta| < pi) and safe under jacfwd/jacrev: every sqrt/division
# is guarded so the *untaken* jnp.where branch cannot poison gradients.
# ---------------------------------------------------------------------------

def so3_log_smooth(R: jnp.ndarray) -> jnp.ndarray:
    """atan2-based SO(3) log, smooth at identity (valid for theta < pi)."""
    w = vee(R - jnp.swapaxes(R, -1, -2))        # 2 sin(theta) * axis
    s_sq = jnp.sum(w * w, axis=-1)
    s = jnp.sqrt(s_sq + 1e-20)                  # ~2 sin(theta), grad-safe at 0
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = jnp.arctan2(s, tr - 1.0)
    small = s < 1e-6
    # theta / (2 sin theta): Taylor 1/2 + theta^2/12 near 0
    s_safe = jnp.where(small, 1.0, s)
    factor = jnp.where(small, 0.5 + theta * theta / 12.0, theta / s_safe)
    return w * factor[..., None]


def log_smooth(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log with smooth derivatives near identity: (...,4,4)->(...,6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log_smooth(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    half = 0.5 * theta
    sin_half = jnp.sin(half)
    sin_half_safe = jnp.where(jnp.abs(sin_half) < 1e-8, 1e-8, sin_half)
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / sin_half_safe) / theta2_safe,
    )
    W = hat(phi)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Jinv = eye - 0.5 * W + coef[..., None, None] * WW
    rho = (Jinv @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — TUM trajectory-file order
# (System/Converter.cpp toQuaternion; Core/Frame.cpp:20-30 stream output).
# ---------------------------------------------------------------------------

def quat_from_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) as (x,y,z,w).

    Branch-free Shepperd's method: compute all four candidate forms and select
    the numerically best by the largest diagonal combination.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # candidate squared*4 values
    qw2 = jnp.maximum(1.0 + tr, 0.0)
    qx2 = jnp.maximum(1.0 + m00 - m11 - m22, 0.0)
    qy2 = jnp.maximum(1.0 - m00 + m11 - m22, 0.0)
    qz2 = jnp.maximum(1.0 - m00 - m11 + m22, 0.0)

    # w-major
    sw = jnp.sqrt(qw2 + 1e-20)
    qa = jnp.stack([(m21 - m12), (m02 - m20), (m10 - m01), sw * sw], axis=-1) / (2.0 * sw[..., None])
    # x-major
    sx = jnp.sqrt(qx2 + 1e-20)
    qb = jnp.stack([sx * sx, (m01 + m10), (m02 + m20), (m21 - m12)], axis=-1) / (2.0 * sx[..., None])
    # y-major
    sy = jnp.sqrt(qy2 + 1e-20)
    qc = jnp.stack([(m01 + m10), sy * sy, (m12 + m21), (m02 - m20)], axis=-1) / (2.0 * sy[..., None])
    # z-major
    sz = jnp.sqrt(qz2 + 1e-20)
    qd = jnp.stack([(m02 + m20), (m12 + m21), sz * sz, (m10 - m01)], axis=-1) / (2.0 * sz[..., None])

    choice = jnp.argmax(jnp.stack([qw2, qx2, qy2, qz2], axis=-1), axis=-1)[..., None]
    q = jnp.select(
        [choice == 0, choice == 1, choice == 2],
        [qa, qb, qc],
        qd,
    )
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rotation_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (...,4) (x,y,z,w) -> rotation matrix (...,3,3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of SE(3): (...,4,4) -> (...,6,6), acting on [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)
