"""Sim(3) — similarity transforms (scale + rotation + translation).

The BASELINE north star names a Sim(3)/SE(3) pose graph. RGB-D depth makes
scale observable, so SE(3) is the live default (the reference's g2o graph is
SE3-only); Sim(3) support enables scale-drift-aware loop closure (monocular-
style) and cross-session map alignment.

Representation: 4x4 matrix [[s*R, t], [0, 1]] with s > 0. Tangent vector
xi = [rho (3), phi (3), sigma (1)].

Implementation note: the translation part of exp/log uses the series
W = sum_n M^n / (n+1)!  with  M = sigma*I + hat(phi)  (the generator of the
translational flow), which converges rapidly for |sigma|, |phi| <= pi and is
branch-free — no Eade-style case analysis, fully autodiff-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3

_W_TERMS = 12  # series terms: ||M|| <= pi + 1 -> term_12 / 13! ~ 1e-7


def _w_matrix(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """W(phi, sigma) = sum_{n>=0} M^n/(n+1)!, M = sigma I + hat(phi)."""
    M = sigma[..., None, None] * jnp.eye(3, dtype=phi.dtype) + se3.hat(phi)
    W = jnp.eye(3, dtype=phi.dtype)
    term = jnp.eye(3, dtype=phi.dtype)
    W = jnp.broadcast_to(W, M.shape)
    term = jnp.broadcast_to(term, M.shape)
    out = W
    for n in range(1, _W_TERMS):
        term = (term @ M) / (n + 1.0)
        out = out + term
    return out


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Sim(3) exponential: (..., 7) [rho, phi, sigma] -> (..., 4, 4)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = se3.so3_exp(phi)
    t = (_w_matrix(phi, sigma) @ rho[..., None])[..., 0]
    return se3.from_Rt(s[..., None, None] * R, t)


def scale_of(S: jnp.ndarray) -> jnp.ndarray:
    """Scale factor of a Sim(3) matrix (det(sR) = s^3)."""
    return jnp.linalg.det(S[..., :3, :3]) ** (1.0 / 3.0)


def log(S: jnp.ndarray) -> jnp.ndarray:
    """Sim(3) log: (..., 4, 4) -> (..., 7). Smooth near identity."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    sigma = jnp.log(s)
    phi = se3.so3_log_smooth(R)
    W = _w_matrix(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def inverse(S: jnp.ndarray) -> jnp.ndarray:
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    R_inv = s_inv[..., None, None] * Rt
    t_inv = -(R_inv @ t[..., None])[..., 0]
    return se3.from_Rt(R_inv, t_inv)


def transform_points(S: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply s*R*p + t."""
    return pts @ jnp.swapaxes(S[..., :3, :3], -1, -2) + S[..., :3, 3][..., None, :]


def from_se3(T, scale=1.0) -> jnp.ndarray:
    out = jnp.asarray(T)
    return out.at[..., :3, :3].multiply(scale)
