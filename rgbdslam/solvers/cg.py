"""Matrix-free block-CG for large pose graphs.

SURVEY.md §7 layer 7: "start dense Cholesky on [6K,6K] (fine to hundreds of
KFs), then Schur/CG". The dense solve is O((6K)^3) and materializes H; for
K >> 1k the Gauss-Newton step instead solves H xi = -g with conjugate
gradients where H is applied *implicitly* from the per-edge blocks:

    (H x)_a = sum_{e: a(e)=a} [Haa_e x_a + Hab_e x_b] + ...

one segment-scatter per CG iteration, O(E * 36) FLOPs — no K^2 memory. A
block-Jacobi preconditioner (inverse of the 6x6 diagonal blocks) keeps the
iteration count low. The same edge-sharded structure as
parallel/dist_ba.py applies: under shard_map, each matvec psum-reduces its
scatter, so CG scales over the mesh with O(K) replicated state instead of
O(K^2).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3
from rgbdslam.solvers.pose_graph import (
    PoseGraphEdges,
    _huber_cost,
    _huber_weight,
    _lm_update,
    _residual_and_jacobians,
    graph_cost,
)


def pcg(H_mv, M_inv, b_rhs, iters: int):
    """Preconditioned conjugate gradients on H x = b.

    H_mv/M_inv: pytree-shaped matvec and preconditioner application (here
    (K, 6) -> (K, 6)). Fixed iteration count (static shape for jit); the
    caller picks `iters` so the Jacobi-preconditioned system converges
    (pose graphs: ~sqrt(condition) ~ graph diameter). Shared by the
    single-device solver below and the edge-sharded distributed variant
    (parallel/dist_ba.py), where H_mv psum-reduces its scatter."""

    def cg_body(i, st):
        x, r, p, rz = st
        Hp = H_mv(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, Hp), 1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        z = M_inv(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return (x, r, p, rz_new)

    x0 = jnp.zeros_like(b_rhs)
    z0 = M_inv(b_rhs)
    st = (x0, b_rhs, z0, jnp.vdot(b_rhs, z0))
    x, _, _, _ = jax.lax.fori_loop(0, iters, cg_body, st)
    return x


def _edge_blocks(Twc, edges: PoseGraphEdges, huber_delta: float):
    """Per-edge GN blocks: Haa, Hbb, Hab (E,6,6); ga, gb (E,6); cost."""
    Ta = Twc[edges.a]
    Tb = Twc[edges.b]
    r, Ja, Jb = jax.vmap(_residual_and_jacobians)(Ta, Tb, edges.Z)
    r_norm = jnp.linalg.norm(r, axis=-1)
    w = edges.weight * _huber_weight(r_norm, huber_delta)
    cost = _huber_cost(r_norm, edges.weight, huber_delta)
    Haa = jnp.einsum("eij,eik,e->ejk", Ja, Ja, w)
    Hbb = jnp.einsum("eij,eik,e->ejk", Jb, Jb, w)
    Hab = jnp.einsum("eij,eik,e->ejk", Ja, Jb, w)
    ga = jnp.einsum("eij,ei,e->ej", Ja, r, w)
    gb = jnp.einsum("eij,ei,e->ej", Jb, r, w)
    return Haa, Hbb, Hab, ga, gb, cost


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def optimize_pose_graph_cg(
    Twc: jnp.ndarray,
    edges: PoseGraphEdges,
    fixed: jnp.ndarray,
    iterations: int = 10,
    cg_iters: int = 50,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    adaptive: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Levenberg-Marquardt with an inner matrix-free preconditioned-CG solve.

    Same problem/convention as optimize_pose_graph (which it matches to CG
    tolerance); memory O(K + E) instead of O(K^2). `adaptive` as in
    optimize_pose_graph: masked step accept/reject with the x2 / /3 lambda
    schedule (g2o Levenberg, Solver/PoseGraph.cpp:30-57).
    """
    K = Twc.shape[0]
    dtype = Twc.dtype
    a_idx, b_idx = edges.a, edges.b
    fixed_f = fixed[:, None].astype(dtype)

    def lm_iter(_, state):
        Twc_cur, lam, _prev = state
        Haa, Hbb, Hab, ga, gb, cost = _edge_blocks(Twc_cur, edges, huber_delta)

        # block-diagonal of H (+ damping) for the Jacobi preconditioner
        D = jnp.zeros((K, 6, 6), dtype=dtype)
        D = D.at[a_idx].add(Haa)
        D = D.at[b_idx].add(Hbb)
        D = D + lam * jnp.eye(6, dtype=dtype)
        # large prior on fixed vertices (gauge)
        D = D + (fixed_f[..., None] * 1e9) * jnp.eye(6, dtype=dtype)
        D_inv = jnp.linalg.inv(D)

        g = jnp.zeros((K, 6), dtype=dtype)
        g = g.at[a_idx].add(ga)
        g = g.at[b_idx].add(gb)

        def H_mv(x):
            """(K, 6) -> (K, 6): implicit H @ x from edge blocks."""
            xa = x[a_idx]
            xb = x[b_idx]
            ya = jnp.einsum("eij,ej->ei", Haa, xa) + jnp.einsum(
                "eij,ej->ei", Hab, xb
            )
            yb = jnp.einsum("eij,ej->ei", Hbb, xb) + jnp.einsum(
                "eji,ej->ei", Hab, xa
            )
            y = jnp.zeros_like(x)
            y = y.at[a_idx].add(ya)
            y = y.at[b_idx].add(yb)
            y = y + lam * x + (fixed_f * 1e9) * x
            return y

        def M_inv(x):
            return jnp.einsum("kij,kj->ki", D_inv, x)

        # preconditioned CG on H xi = -g
        xi = pcg(H_mv, M_inv, -g, cg_iters)
        xi = jnp.where(fixed[:, None], 0.0, xi)
        Twc_cand = se3.exp(xi) @ Twc_cur
        if not adaptive:
            return (Twc_cand, lam, cost)
        cost_new = graph_cost(Twc_cand, edges, huber_delta)
        accept = cost_new < cost
        Twc_next, lam_next, cost_next = _lm_update(
            accept, lam, cost, cost_new, Twc_cur, Twc_cand)
        return (Twc_next, lam_next, cost_next)

    Twc_opt, _lam, cost = jax.lax.fori_loop(
        0, iterations, lm_iter,
        (Twc, jnp.asarray(lm_lambda0, dtype), jnp.asarray(jnp.inf, dtype)),
    )
    return Twc_opt, cost
