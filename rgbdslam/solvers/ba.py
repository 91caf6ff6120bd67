"""Local bundle adjustment: landmark-keyframe Gauss-Newton with Schur
complement over landmark blocks.

The reference has no BA (its backend is pose-graph-only; landmarks are only
re-anchored after optimization, Core/Frame.cpp:437-454) — but SURVEY.md §7
layer 7 / BASELINE config 3 call for landmark-keyframe local BA as a
first-class capability of the new framework. Structure:

- observations live in a fixed-shape landmark-major table: each landmark has
  up to M_OBS observations (keyframe index, pixel, validity) — no dynamic
  per-landmark lists;
- per-iteration, all residuals/Jacobians are one vmapped evaluation (L, M);
- the landmark blocks H_ll are batched 3x3 inverses; the Schur complement
  S = H_cc - sum_l G_l H_ll^-1 G_l^T is assembled with one big scatter-add of
  (L, M, M) 6x6 blocks into the dense reduced camera system (K keyframes in
  the window, so 6K x 6K stays small);
- the reduced solve is a dense Cholesky, followed by batched landmark
  back-substitution.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera
from rgbdslam.solvers.ransac_se3 import _inv3x3


class BAEdges(NamedTuple):
    """Relative-pose factors folded into the BA normal equations.

    Landmark tracks drift with viewpoint (the detected corner slides), so a
    landmark-only global BA is *less* accurate than the pose graph built from
    dense 500-point RANSAC registrations. Joint optimization keeps both: the
    edge factors carry the pairwise registration information (the reference's
    g2o edges, Solver/PoseGraph.cpp:199-217), the landmark terms add
    cross-view structure.
    """

    a: jnp.ndarray   # (E,) i32 vertex a (the 'current' side of Z = T_{a<-b})
    b: jnp.ndarray   # (E,) i32 vertex b
    Z: jnp.ndarray   # (E, 4, 4) measured T_{a<-b} in the Twc convention
    w: jnp.ndarray   # (E,) information weight; 0 disables (padding)


class BAProblem(NamedTuple):
    Tcw: jnp.ndarray        # (K, 4, 4) keyframe poses (world->camera)
    Xw: jnp.ndarray         # (L, 3) landmark positions
    lm_valid: jnp.ndarray   # (L,) bool
    obs_kf: jnp.ndarray     # (L, M) i32 observing keyframe index
    obs_uv: jnp.ndarray     # (L, M, 2) f32 observed (undistorted) pixels
    obs_valid: jnp.ndarray  # (L, M) bool
    obs_z: jnp.ndarray      # (L, M) f32 measured depth (0 = no depth term).
    # The depth residual is what makes this an RGB-D BA: reprojection-only
    # BA with free landmarks has a scale gauge freedom (only pixel rays are
    # constrained); the measured z pins metric scale, weighted by the
    # Khoshelham model sigma_z = c*z^2 (Solver/SolverSE3.cpp:289-297).


def _reproj_jacobians(cam: Camera, Tcw_o: jnp.ndarray, Xw: jnp.ndarray,
                      depth_sigma_factor: float = 0.01):
    """Residual pieces for observations (u, v, scaled z).

    Tcw_o: (..., 4, 4) per-observation poses; Xw: (..., 3) landmark (bcast).
    Returns predicted (u, v, z) (..., 3), Jc (..., 3, 6) wrt pose
    left-increment, Jl (..., 3, 3) wrt landmark position, and the z-row
    weight (1/sigma_z, converting the depth residual to a unit comparable to
    pixels under unit pixel noise).
    """
    R = Tcw_o[..., :3, :3]
    t = Tcw_o[..., :3, 3]
    Xc = jnp.einsum("...ij,...j->...i", R, Xw) + t
    x, y = Xc[..., 0], Xc[..., 1]
    z = jnp.maximum(Xc[..., 2], 1e-6)
    inv_z = 1.0 / z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    uvz = jnp.stack([u, v, Xc[..., 2]], axis=-1)

    # d(u,v,z)/d(Xc): (..., 3, 3)
    zero = jnp.zeros_like(inv_z)
    one = jnp.ones_like(inv_z)
    duvz_dXc = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z * inv_z], axis=-1),
            jnp.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z * inv_z], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    # d(Xc)/d(xi) for Tcw <- exp(xi) Tcw: [I | -hat(Xc)]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3))
    dXc_dxi = jnp.concatenate([eye, -se3.hat(Xc)], axis=-1)  # (..., 3, 6)
    Jc = duvz_dXc @ dXc_dxi                                  # (..., 3, 6)
    Jl = duvz_dXc @ R                                        # (..., 3, 3)
    sigma_z = depth_sigma_factor * z * z
    return uvz, Jc, Jl, 1.0 / jnp.maximum(sigma_z, 1e-4)


def _ba_cost(cam: Camera, Tcw, Xw, problem: "BAProblem", huber_delta: float,
             edges: "BAEdges | None", edge_huber: float):
    """Robust BA objective at (Tcw, Xw) — the residual-only evaluation the
    LM accept/reject compares (the Jacobian outputs of _reproj_jacobians are
    dead code here and DCE'd by XLA). Uses the plain Huber cost (no
    gross-outlier prune: the prune is a quadratic-model approximation; the
    Huber linear tail already bounds each term's influence)."""
    from rgbdslam.solvers.pose_graph import _huber_cost

    dtype = Tcw.dtype
    uvz_hat, _, _, inv_sigma_z = _reproj_jacobians(
        cam, Tcw[problem.obs_kf], Xw[:, None, :]
    )
    z = uvz_hat[..., 2]
    meas = jnp.concatenate([problem.obs_uv, problem.obs_z[..., None]], axis=-1)
    r = uvz_hat - meas
    sz = jnp.where(problem.obs_z > 0, inv_sigma_z, 0.0)
    r = r * jnp.stack([jnp.ones_like(sz), jnp.ones_like(sz), sz], axis=-1)
    ok = problem.obs_valid & problem.lm_valid[:, None] & (z > 0.05)
    r_norm = jnp.linalg.norm(r, axis=-1)
    cost = _huber_cost(r_norm, ok.astype(dtype), huber_delta)
    if edges is not None:
        r_e = jax.vmap(
            lambda Ta, Tb, Z: se3.log_smooth(
                se3.inverse(Z) @ Ta @ se3.inverse(Tb))
        )(Tcw[edges.a], Tcw[edges.b], edges.Z)
        cost = cost + _huber_cost(
            jnp.linalg.norm(r_e, axis=-1), edges.w, edge_huber)
    return cost


def _edge_residual_jacobians(Tcw_a, Tcw_b, Z):
    """Edge residual r = log(Z^-1 Twc_a^-1 Twc_b) with Twc = Tcw^-1, and its
    Jacobians wrt *Tcw* left increments (matching the BA pose update
    Tcw <- exp(xi) Tcw). Mirrors solvers/pose_graph.py's g2o EdgeSE3
    convention so graph edges and BA factors agree."""

    def f(x):
        Ta = se3.exp(x[:6]) @ Tcw_a
        Tb = se3.exp(x[6:]) @ Tcw_b
        return se3.log_smooth(se3.inverse(Z) @ Ta @ se3.inverse(Tb))

    x0 = jnp.zeros((12,), Tcw_a.dtype)
    r = f(x0)
    J = jax.jacfwd(f)(x0)
    return r, J[:, :6], J[:, 6:]


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 8))
def local_ba(
    cam: Camera,
    problem: BAProblem,
    fixed_kf: jnp.ndarray,
    iterations: int = 5,
    huber_delta: float = 2.45,   # sqrt(5.991), the g2o convention
    lm_lambda0: float = 1e-4,
    edges: BAEdges | None = None,
    edge_huber: float = 1.0,     # pose-graph Huber width (PoseGraphConfig)
    adaptive: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Optimize keyframe poses + landmark positions (+ optional relative-pose
    edge factors for joint pose-graph/landmark optimization) with
    Levenberg-Marquardt (masked accept/reject on the joint (Tcw, Xw) step,
    x2 / /3 lambda schedule — g2o Levenberg, Solver/PoseGraph.cpp:30-57;
    `adaptive=False` = the old fixed-damping Gauss-Newton for A/B tests).

    Returns (Tcw_opt [K,4,4], Xw_opt [L,3], final_cost []).
    fixed_kf: (K,) bool — gauge anchors (typically the oldest window KF).
    """
    from rgbdslam.solvers.pose_graph import (_huber_cost, _lm_update)

    K = problem.Tcw.shape[0]
    L, M = problem.obs_kf.shape
    dtype = problem.Tcw.dtype

    def lm_iter(_, state):
        Tcw, Xw, lam, _prev = state
        Tcw_o = Tcw[problem.obs_kf]                       # (L, M, 4, 4)
        uvz_hat, Jc, Jl, inv_sigma_z = _reproj_jacobians(
            cam, Tcw_o, Xw[:, None, :]
        )
        z = uvz_hat[..., 2]
        meas = jnp.concatenate(
            [problem.obs_uv, problem.obs_z[..., None]], axis=-1
        )
        r = uvz_hat - meas                                 # (L, M, 3)
        # scale the depth row into pixel-comparable units; no depth -> row off
        has_z = problem.obs_z > 0
        sz = jnp.where(has_z, inv_sigma_z, 0.0)
        scale = jnp.stack([jnp.ones_like(sz), jnp.ones_like(sz), sz], axis=-1)
        r = r * scale
        Jc = Jc * scale[..., None]
        Jl = Jl * scale[..., None]

        ok0 = problem.obs_valid & problem.lm_valid[:, None] & (z > 0.05)
        r_norm = jnp.linalg.norm(r, axis=-1)
        # gross-outlier pruning (wrong data associations): beyond 10x the
        # Huber width an observation contributes nothing, mirroring the
        # reference's chi^2 demotion idea (Solver/PnPSolver.cpp:117-124)
        ok = ok0 & (r_norm < 10.0 * huber_delta)
        w_h = jnp.where(r_norm > huber_delta,
                        huber_delta / jnp.maximum(r_norm, 1e-9), 1.0)
        w = w_h * ok.astype(dtype)                         # (L, M)
        # accept/reject cost uses the UN-pruned mask so it matches _ba_cost's
        # candidate evaluation (the prune shapes the quadratic model only)
        cost = _huber_cost(r_norm, ok0.astype(dtype), huber_delta)

        # landmark blocks
        Hll = jnp.einsum("lmri,lmrj,lm->lij", Jl, Jl, w)   # (L, 3, 3)
        Hll = Hll + (lam + 1e-6) * jnp.eye(3, dtype=dtype)
        bl = jnp.einsum("lmri,lmr,lm->li", Jl, r, w)       # (L, 3)
        Hll_inv = _inv3x3(Hll)

        # camera diagonal blocks + rhs
        Hcc_o = jnp.einsum("lmri,lmrj,lm->lmij", Jc, Jc, w)  # (L, M, 6, 6)
        bc_o = jnp.einsum("lmri,lmr,lm->lmi", Jc, r, w)      # (L, M, 6)
        # coupling G = Jc^T W Jl per observation
        G = jnp.einsum("lmri,lmrj,lm->lmij", Jc, Jl, w)      # (L, M, 6, 3)

        H = jnp.zeros((K, 6, K, 6), dtype=dtype)
        kf = problem.obs_kf
        H = H.at[kf, :, kf, :].add(Hcc_o)
        g = jnp.zeros((K, 6), dtype=dtype).at[kf].add(bc_o)

        # relative-pose edge factors (touch poses only; independent of the
        # landmark Schur elimination below)
        if edges is not None:
            r_e, Ja, Jb = jax.vmap(_edge_residual_jacobians)(
                Tcw[edges.a], Tcw[edges.b], edges.Z
            )
            rn_e = jnp.linalg.norm(r_e, axis=-1)
            hub = jnp.where(rn_e > edge_huber,
                            edge_huber / jnp.maximum(rn_e, 1e-9), 1.0)
            we = (edges.w * hub)[:, None, None]
            H = H.at[edges.a, :, edges.a, :].add(
                we * jnp.einsum("eri,erj->eij", Ja, Ja))
            H = H.at[edges.a, :, edges.b, :].add(
                we * jnp.einsum("eri,erj->eij", Ja, Jb))
            H = H.at[edges.b, :, edges.a, :].add(
                we * jnp.einsum("eri,erj->eij", Jb, Ja))
            H = H.at[edges.b, :, edges.b, :].add(
                we * jnp.einsum("eri,erj->eij", Jb, Jb))
            g = g.at[edges.a].add(we[:, :, 0] * jnp.einsum("eri,er->ei", Ja, r_e))
            g = g.at[edges.b].add(we[:, :, 0] * jnp.einsum("eri,er->ei", Jb, r_e))
            cost = cost + _huber_cost(rn_e, edges.w, edge_huber)

        # Schur: S -= G_a Hll^-1 G_b^T over observation pairs of each landmark
        GHinv = jnp.einsum("lmij,ljk->lmik", G, Hll_inv)     # (L, M, 6, 3)
        S_blocks = jnp.einsum("laij,lbkj->labik", GHinv, G)  # (L, M, M, 6, 6)
        kf_a = jnp.broadcast_to(kf[:, :, None], (L, M, M))
        kf_b = jnp.broadcast_to(kf[:, None, :], (L, M, M))
        H = H.at[kf_a, :, kf_b, :].add(-S_blocks)
        # rhs reduction: g_red = g - G Hll^-1 bl
        g_red_o = jnp.einsum("lmik,lk->lmi", GHinv, bl)      # (L, M, 6)
        g = g.at[kf].add(-g_red_o)

        Hm = H.reshape(K * 6, K * 6)
        gv = g.reshape(K * 6)
        diag_boost = jnp.where(jnp.repeat(fixed_kf, 6), 1e9, lam + 1e-8)
        Hm = Hm + jnp.diag(diag_boost) + lam * jnp.diag(jnp.diag(Hm))
        xi = -jnp.linalg.solve(Hm, gv).reshape(K, 6)
        xi = jnp.where(fixed_kf[:, None], 0.0, xi)

        # landmark back-substitution: dX = -Hll^-1 (bl + sum_m G^T xi[kf])
        Gt_xi = jnp.einsum("lmij,lmi->lj", G, xi[kf])        # (L, 3)
        dX = -jnp.einsum("lij,lj->li", Hll_inv, bl + Gt_xi)
        obs_cnt = jnp.sum(w, axis=1)
        dX = jnp.where((problem.lm_valid & (obs_cnt > 0))[:, None], dX, 0.0)

        Tcw_cand = se3.exp(xi) @ Tcw
        Xw_cand = Xw + dX
        if not adaptive:
            return (Tcw_cand, Xw_cand, lam, cost)
        cost_new = _ba_cost(cam, Tcw_cand, Xw_cand, problem, huber_delta,
                            edges, edge_huber)
        accept = cost_new < cost
        (Tcw_next, Xw_next), lam_next, cost_next = _lm_update(
            accept, lam, cost, cost_new, (Tcw, Xw), (Tcw_cand, Xw_cand))
        return (Tcw_next, Xw_next, lam_next, cost_next)

    Tcw_opt, Xw_opt, _lam, cost = jax.lax.fori_loop(
        0, iterations, lm_iter,
        (problem.Tcw, problem.Xw, jnp.asarray(lm_lambda0, dtype),
         jnp.asarray(jnp.inf, dtype)),
    )
    return Tcw_opt, Xw_opt, cost
