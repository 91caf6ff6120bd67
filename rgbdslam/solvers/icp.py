"""ICP / GICP refinement as fixed-iteration Gauss-Newton on SE(3), batched.

Array-program replacement for pcl::GeneralizedIterativeClosestPoint over the
matched-keypoint 3D sets (Solver/Gicp.cpp:37-66): warm-started from the RANSAC
transform, it refines T21 so that R p1 + t ~= p2.

Re-design notes:
- PCL GICP re-associates nearest neighbors per iteration via kd-tree
  (Solver/Gicp.cpp:54-66). Default here: with a warm start and gated
  correspondences (max_correspondence_dist, Solver/Gicp.cpp:13 /
  System/Tracking.cpp:148) the given keypoint matches ARE the associations
  for all inliers, so we keep the match pairing and apply the distance gate
  per iteration (trimmed GN). IcpConfig.reassociate=True restores PCL's
  per-iteration re-pairing as one dense (N, N) distance contraction — no
  trees on device — which recovers from wrong descriptor pairings (the
  rmse >= 0.8 regime that triggers GICP in the first place).
- Plane-to-plane (GICP) weighting: per-point covariances from the k nearest
  neighbors inside each matched set, regularized as in Segal et al. (eigenvalue
  floor epsilon), combined per-pair as  W = (C2 + R C1 R^T)^{-1}.
- The Gauss-Newton normal equations are a 6x6 solve — built with one einsum
  over all correspondences, iterated with lax.fori_loop. On the GPU the
  whole loop runs as one Pallas kernel (ops/pallas_kernels.py), chosen by
  ops/backend.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from rgbdslam.config import IcpConfig
from rgbdslam.geometry import se3
from rgbdslam.ops.backend import kernel_impl
from rgbdslam.ops.pallas_kernels import gicp_refine_kernel
from rgbdslam.solvers.ransac_se3 import _inv3x3


def knn_covariances(
    pts: jnp.ndarray, valid: jnp.ndarray, k: int = 8, epsilon: float = 1e-3
) -> jnp.ndarray:
    """GICP-style regularized covariance per point from its k-NN.

    pts: (N, 3), valid: (N,). Returns (N, 3, 3). Covariances are rebuilt as
    U diag(eps-floored eigvals normalized) U^T per Segal's plane-to-plane
    model; we approximate with a soft floor: C + eps * tr(C)/3 * I, which
    conditions the information matrix the same way without an eigendecomp.
    """
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(valid[None, :] & valid[:, None], d2, jnp.inf)
    d2 = jnp.fill_diagonal(d2, jnp.inf, inplace=False)
    # k nearest neighbors per point (approximate partial reduction; exact
    # top_k sorts the whole row)
    neg, idx = jax.lax.approx_max_k(-d2, k)  # (N, k)
    nbr = pts[idx]                     # (N, k, 3)
    w = jnp.isfinite(-neg).astype(pts.dtype)  # (N, k) valid-neighbor mask
    wsum = jnp.maximum(w.sum(-1, keepdims=True), 1.0)
    mean = jnp.sum(nbr * w[..., None], axis=1) / wsum
    cent = (nbr - mean[:, None, :]) * w[..., None]
    C = jnp.einsum("nki,nkj->nij", cent, cent) / wsum[..., None]
    tr = jnp.trace(C, axis1=-2, axis2=-1)
    eye = jnp.eye(3, dtype=pts.dtype)
    return C + (epsilon * jnp.maximum(tr, 1e-4) / 3.0)[..., None, None] * eye


def depth_patch_covariances(
    cam, depth: jnp.ndarray, uv: jnp.ndarray, radius: int = 2,
    epsilon: float = 1e-3,
) -> jnp.ndarray:
    """Per-keypoint surface covariance from the depth-image neighborhood.

    The kNN covariances above approximate local structure from the *sparse*
    matched set; the depth image gives the true surface directly
    (SURVEY.md §7 design stance: "depth-image neighborhoods for
    normals/covariances, avoiding kd-trees"): backproject the
    (2r+1)^2 patch around each keypoint and take its covariance, with the
    same soft eigenvalue floor as knn_covariances. Invalid-depth pixels in
    the patch are masked.

    cam: static Camera; depth: (H, W) meters; uv: (N, 2). Returns (N, 3, 3).

    Structure: dense per-pixel moment maps (10 box-filtered product
    images) sampled at the N keypoints, instead of N per-keypoint patch
    gathers. Windows are zero-weighted outside the image (keypoints sit >= min_border
    from the edge, so the live path never sees the difference).
    """
    from rgbdslam.geometry.camera import Camera  # noqa: F401  (typing)
    from rgbdslam.ops import image as image_ops

    h, w = depth.shape
    ok = (depth > 0).astype(depth.dtype)
    col = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    x = (col - cam.cx) / cam.fx * depth          # masked by ok below
    y = (row - cam.cy) / cam.fy * depth
    z = depth

    def bsum(a):
        return image_ops.box_filter_sum(a * ok, radius)

    n = jnp.maximum(image_ops.box_filter_sum(ok, radius), 1.0)
    planes = {
        "x": bsum(x), "y": bsum(y), "z": bsum(z),
        "xx": bsum(x * x), "xy": bsum(x * y), "xz": bsum(x * z),
        "yy": bsum(y * y), "yz": bsum(y * z), "zz": bsum(z * z),
    }

    def at(img):
        return image_ops.nearest_sample(img, uv)             # (N,)

    nn = at(n)
    mx, my, mz = at(planes["x"]) / nn, at(planes["y"]) / nn, at(planes["z"]) / nn
    Cxx = at(planes["xx"]) / nn - mx * mx
    Cxy = at(planes["xy"]) / nn - mx * my
    Cxz = at(planes["xz"]) / nn - mx * mz
    Cyy = at(planes["yy"]) / nn - my * my
    Cyz = at(planes["yz"]) / nn - my * mz
    Czz = at(planes["zz"]) / nn - mz * mz
    C = jnp.stack([
        jnp.stack([Cxx, Cxy, Cxz], axis=-1),
        jnp.stack([Cxy, Cyy, Cyz], axis=-1),
        jnp.stack([Cxz, Cyz, Czz], axis=-1),
    ], axis=-2)                                              # (N, 3, 3)
    tr = Cxx + Cyy + Czz
    eye = jnp.eye(3, dtype=depth.dtype)
    return C + (epsilon * jnp.maximum(tr, 1e-4) / 3.0)[..., None, None] * eye


def _gn_step(T, p1, p2, W, valid, max_dist):
    """One Gauss-Newton step for min sum r^T W r, r = R p1 + t - p2.

    Jacobian of r wrt xi = [rho, phi] (left-multiplied increment,
    T <- exp(xi) T):  J = [I | -hat(R p1 + t)].
    """
    R = T[:3, :3]
    t = T[:3, 3]
    q = p1 @ R.T + t                 # (N, 3) transformed source
    r = q - p2                       # (N, 3)
    dist = jnp.linalg.norm(r, axis=-1)
    gate = valid & (dist < max_dist)
    wm = gate.astype(T.dtype)

    Jrot = -se3.hat(q)               # (N, 3, 3)
    # J = [I3 | Jrot] per point: (N, 3, 6)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), Jrot.shape)
    J = jnp.concatenate([eye, Jrot], axis=-1)
    WJ = W @ J                        # (N, 3, 6)
    H = jnp.einsum("nij,nik,n->jk", J, WJ, wm)       # (6, 6)
    b = jnp.einsum("nij,ni,n->j", WJ, r, wm)          # (6,)
    H = H + 1e-6 * jnp.eye(6, dtype=T.dtype)
    xi = -jnp.linalg.solve(H, b)
    T_new = se3.exp(xi) @ T
    cost = jnp.sum(jnp.einsum("ni,nij,nj->n", r, W, r) * wm)
    return T_new, cost, jnp.sum(wm)


@functools.partial(jax.jit, static_argnums=(5,))
def gicp_refine(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    valid: jnp.ndarray,
    T_init: jnp.ndarray,
    key_unused: jnp.ndarray | None = None,
    cfg: IcpConfig = IcpConfig(),
    C1: jnp.ndarray | None = None,
    C2: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Plane-to-plane refinement of T21 over matched camera-frame points.

    Returns (T21, converged: bool, matched_count: int32). Matches reference
    gating: requires >= cfg.min_matches valid pairs (Solver/Gicp.cpp:23);
    falls back to T_init when under-constrained.

    C1/C2: optional precomputed per-point covariances (N, 3, 3) — e.g. the
    depth-image surface covariances from depth_patch_covariances, which are
    both cheaper and geometrically faithful; defaults to sparse-set kNN
    covariances (the PCL GICP behavior).
    """
    if C1 is None:
        C1 = knn_covariances(p1, valid, epsilon=cfg.gicp_epsilon)
    if C2 is None:
        C2 = knn_covariances(p2, valid, epsilon=cfg.gicp_epsilon)

    if (not cfg.reassociate
            and kernel_impl("gicp", size=p1.shape[0]) == "triton"):
        T_fin, _cost, _cnt = gicp_refine_kernel(
            T_init.astype(jnp.float32), p1, p2, C1, C2, valid,
            cfg.max_iterations, cfg.max_correspondence_dist,
        )
        return _finish_gicp(T_fin, T_init, p1, p2, valid, cfg)

    def body(i, carry):
        T, _ = carry
        R = T[:3, :3]
        if cfg.reassociate:
            # PCL GICP re-finds nearest neighbors each iteration
            # (Solver/Gicp.cpp:54-66): re-pair every source point with its
            # nearest valid target under the current transform — one (N, N)
            # distance contraction instead of a kd-tree. Recovers from
            # wrong descriptor pairings, which is exactly the rmse >= 0.8
            # regime that triggers GICP.
            q = p1 @ R.T + T[:3, 3]
            d2 = jnp.sum((q[:, None, :] - p2[None, :, :]) ** 2, axis=-1)
            d2 = jnp.where(valid[None, :], d2, jnp.inf)
            j = jnp.argmin(d2, axis=1)
            p2_i, C2_i = p2[j], C2[j]
        else:
            p2_i, C2_i = p2, C2
        C1r = jnp.einsum("ij,njk,lk->nil", R, C1, R)
        W = _inv3x3(C1r + C2_i)
        T_new, cost, _ = _gn_step(T, p1, p2_i, W, valid,
                                  cfg.max_correspondence_dist)
        return (T_new, cost)

    T_fin, _ = jax.lax.fori_loop(0, cfg.max_iterations, body, (T_init, jnp.inf))
    return _finish_gicp(T_fin, T_init, p1, p2, valid, cfg)


def _finish_gicp(T_fin, T_init, p1, p2, valid, cfg: IcpConfig):
    """Convergence gate + fallback (shared by the XLA and kernel paths)."""
    n_valid = jnp.sum(valid)
    enough = n_valid >= cfg.min_matches
    # convergence proxy: final gated correspondence count stays >= min_matches
    R = T_fin[:3, :3]
    q = p1 @ R.T + T_fin[:3, 3]
    if cfg.reassociate:
        d2 = jnp.sum((q[:, None, :] - p2[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(valid[None, :], d2, jnp.inf)
        p2_fin = p2[jnp.argmin(d2, axis=1)]
    else:
        p2_fin = p2
    gated = valid & (jnp.linalg.norm(q - p2_fin, axis=-1)
                     < cfg.max_correspondence_dist)
    converged = enough & (jnp.sum(gated) >= cfg.min_matches)
    converged = converged & jnp.isfinite(T_fin).all()
    T_out = jnp.where(converged, T_fin, T_init)
    return T_out, converged, n_valid.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(4,))
def point_to_plane_icp(
    src_pts: jnp.ndarray,
    dst_pts: jnp.ndarray,
    dst_normals: jnp.ndarray,
    T_init: jnp.ndarray,
    iters: int = 10,
    max_dist: float = 0.25,
) -> jnp.ndarray:
    """Dense point-to-plane ICP with *given* correspondences (projective
    association happens upstream in the dense-depth pipeline).

    src_pts/dst_pts: (N, 3) with invalid entries at z<=0; dst_normals (N, 3).
    Minimizes sum ((R s + t - d) . n)^2.
    """
    valid = (src_pts[:, 2] > 0) & (dst_pts[:, 2] > 0)

    def body(i, T):
        R = T[:3, :3]
        t = T[:3, 3]
        q = src_pts @ R.T + t
        r = jnp.sum((q - dst_pts) * dst_normals, axis=-1)  # (N,)
        gate = valid & (jnp.abs(r) < max_dist)
        wm = gate.astype(T.dtype)
        Jr = jnp.concatenate([dst_normals, jnp.cross(q, dst_normals)], axis=-1)  # (N,6)
        # note: d r / d xi with r = n.(exp(xi) q - d):  [n | (q x n)]... using
        # left increment J = [n^T, -n^T hat(q)] = [n, q x n]
        H = jnp.einsum("ni,nj,n->ij", Jr, Jr, wm) + 1e-6 * jnp.eye(6, dtype=T.dtype)
        b = jnp.einsum("ni,n,n->i", Jr, r, wm)
        xi = -jnp.linalg.solve(H, b)
        return se3.exp(xi) @ T

    return jax.lax.fori_loop(0, iters, body, T_init)
