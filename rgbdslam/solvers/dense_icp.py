"""Dense projective ICP odometry: coarse-to-fine point-to-plane on depth maps.

The reference refines with PCL GICP over sparse matched keypoints
(Solver/Gicp.cpp); this module adds the dense-depth equivalent the SURVEY
build plan targets for ICL-NUIM-class sequences (SURVEY.md §7 layer 6):
RGB-D gives projective data association for free — no kd-trees:

  for each reference pixel: p_ref -> q = T p_ref -> project into the current
  frame -> read the current point/normal at that pixel -> point-to-plane
  residual n . (q - p_cur).

Normals come from depth-map finite differences (cross product of the
backprojected tangents). The Gauss-Newton normal equations reduce over all
pixels with one einsum; iterations run coarse-to-fine over a depth pyramid
(nearest-neighbor 2x subsampling keeps depth edges crisp).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera, depth_to_points


def scaled_camera(cam: Camera, scale: int) -> Camera:
    """Camera for a 1/scale resolution level."""
    import dataclasses

    return dataclasses.replace(
        cam,
        fx=cam.fx / scale, fy=cam.fy / scale,
        cx=cam.cx / scale, cy=cam.cy / scale,
        width=cam.width // scale, height=cam.height // scale,
    )


def depth_normals(cam: Camera, depth: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Backprojected points (H,W,3) + normals (H,W,3) from central diffs.

    Normals are oriented toward the camera (n.z < 0 ... camera looks +z, so
    wall normals face -z); invalid where depth is missing or neighbors jump.
    """
    pts = depth_to_points(cam, depth)
    dx = jnp.zeros_like(pts)
    dy = jnp.zeros_like(pts)
    dx = dx.at[:, 1:-1].set(pts[:, 2:] - pts[:, :-2])
    dy = dy.at[1:-1, :].set(pts[2:, :] - pts[:-2, :])
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # orient toward camera: flip if pointing away (dot(n, p) > 0)
    flip = jnp.sum(n * pts, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    valid = (
        (depth > 0)
        & (norm[..., 0] > 1e-9)
        # depth-edge rejection: neighbor jumps kill the normal estimate
        & (jnp.linalg.norm(dx, axis=-1) < 0.3)
        & (jnp.linalg.norm(dy, axis=-1) < 0.3)
    )
    return pts, jnp.where(valid[..., None], n, 0.0)


def _icp_level(cam_l: Camera, d_ref: jnp.ndarray, d_cur: jnp.ndarray,
               T_init: jnp.ndarray, iters: int, max_dist: float) -> jnp.ndarray:
    p_ref = depth_to_points(cam_l, d_ref)          # (H, W, 3)
    p_cur, n_cur = depth_normals(cam_l, d_cur)
    h, w = d_ref.shape
    src = p_ref.reshape(-1, 3)
    src_valid = (d_ref > 0).reshape(-1)

    def body(i, T):
        R = T[:3, :3]
        t = T[:3, 3]
        q = src @ R.T + t                           # (N, 3)
        z = jnp.maximum(q[:, 2], 1e-6)
        u = jnp.clip(jnp.round(cam_l.fx * q[:, 0] / z + cam_l.cx).astype(jnp.int32), 0, w - 1)
        v = jnp.clip(jnp.round(cam_l.fy * q[:, 1] / z + cam_l.cy).astype(jnp.int32), 0, h - 1)
        inb = (
            (q[:, 2] > 0.05)
            & (cam_l.fx * q[:, 0] / z + cam_l.cx >= 0)
            & (cam_l.fx * q[:, 0] / z + cam_l.cx <= w - 1)
            & (cam_l.fy * q[:, 1] / z + cam_l.cy >= 0)
            & (cam_l.fy * q[:, 1] / z + cam_l.cy <= h - 1)
        )
        pc = p_cur[v, u]
        nc = n_cur[v, u]
        r = jnp.sum((q - pc) * nc, axis=-1)
        gate = (
            src_valid & inb & (pc[:, 2] > 0)
            & (jnp.linalg.norm(q - pc, axis=-1) < max_dist)
            & (jnp.sum(nc * nc, axis=-1) > 0.5)
        )
        wm = gate.astype(T.dtype)
        J = jnp.concatenate([nc, jnp.cross(q, nc)], axis=-1)  # (N, 6)
        H = jnp.einsum("ni,nj,n->ij", J, J, wm) + 1e-5 * jnp.eye(6, dtype=T.dtype)
        g = jnp.einsum("ni,n,n->i", J, r, wm)
        xi = -jnp.linalg.solve(H, g)
        return se3.exp(xi) @ T

    return jax.lax.fori_loop(0, iters, body, T_init)


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
def dense_icp(
    cam: Camera,
    depth_ref: jnp.ndarray,
    depth_cur: jnp.ndarray,
    T_init: jnp.ndarray,
    levels: Tuple[int, ...] = (4, 2),
    iters_per_level: int = 10,
    max_dist: float = 0.3,
    max_correction: Tuple[float, float] = (0.5, 0.6),
) -> jnp.ndarray:
    """Estimate T21 (ref-camera -> cur-camera coords) by coarse-to-fine
    projective point-to-plane ICP. `levels` are subsampling factors, coarse
    first (the full-resolution level is rarely worth its gather cost —
    (4, 2) tracks to mm-level on clean depth)."""
    T = T_init
    for s in levels:
        cam_l = scaled_camera(cam, s)
        d_r = depth_ref[::s, ::s]
        d_c = depth_cur[::s, ::s]
        T = _icp_level(cam_l, d_r, d_c, T, iters_per_level, max_dist)

    # trust gate: projective association is only valid near the warm start;
    # a refinement that wanders beyond `max_correction` (trans [m], rot [rad])
    # is divergence, not refinement — keep the initial estimate. Also guards
    # the non-finite case (singular normal equations). Callers with a good
    # warm start (tracker refinement) should pass a tight bound.
    delta = se3.inverse(T_init) @ T
    dt = se3.translation_norm(delta)
    dr = se3.rotation_angle(delta)
    ok = jnp.isfinite(T).all() & (dt < max_correction[0]) & (dr < max_correction[1])
    return jnp.where(ok, T, T_init)
