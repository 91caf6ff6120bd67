"""Distributed pose-graph / bundle-adjustment over a device mesh.

The reference is single-process (SURVEY.md §2.7: no distributed backend);
this module adds the multi-device scaling axis (§2.7 P7/P8): shard the *edge*
set (the O(E) work: residuals, Jacobians, block outer products) across a 1-D
`Mesh` with `shard_map`, reduce the Gauss-Newton normal equations with `psum`
over ICI, and solve the (replicated) 6Kx6K system on every device — the solve
is O(K^3) but K (keyframes) is orders of magnitude smaller than E after
proximity/loop densification, so edge-sharding is where the parallel win is.

Also provides the data-parallel frontend: a batch of frames sharded across
devices, each running the full feature pipeline locally (embarrassingly
parallel — the reference's per-cell OpenMP loop, P5, scaled to chips).

All functions are pure and mesh-parameterized; they run identically on a real
multi-GPU host or on the `--xla_force_host_platform_device_count` CPU mesh used in
tests and the driver's multi-chip dry run.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rgbdslam.geometry import se3
from rgbdslam.solvers.pose_graph import (
    PoseGraphEdges,
    _huber_cost,
    _huber_weight,
    _lm_update,
    _residual_and_jacobians,
    edge_residual,
)


def _local_graph_cost(Twc, edges: PoseGraphEdges, huber_delta: float):
    """This shard's contribution to the robust objective (residual-only);
    callers psum it over the mesh."""
    r = jax.vmap(edge_residual)(Twc[edges.a], Twc[edges.b], edges.Z)
    return _huber_cost(jnp.linalg.norm(r, axis=-1), edges.weight, huber_delta)


def make_mesh(n_devices: int | None = None, axis: str = "edges") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_edges(edges: PoseGraphEdges, mesh: Mesh, axis: str = "edges") -> PoseGraphEdges:
    """Pad E to a multiple of the mesh size and device_put with edge sharding."""
    n_dev = mesh.shape[axis]
    E = edges.a.shape[0]
    Ep = ((E + n_dev - 1) // n_dev) * n_dev
    pad = Ep - E

    def pad_arr(x, fill=0):
        if pad == 0:
            return x
        pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width, constant_values=fill)

    Z_pad = edges.Z
    if pad:
        Z_pad = jnp.concatenate(
            [edges.Z, jnp.broadcast_to(jnp.eye(4, dtype=edges.Z.dtype), (pad, 4, 4))]
        )
    padded = PoseGraphEdges(
        a=pad_arr(edges.a), b=pad_arr(edges.b), Z=Z_pad, weight=pad_arr(edges.weight)
    )
    sharding = NamedSharding(mesh, P(axis))
    return PoseGraphEdges(
        a=jax.device_put(padded.a, sharding),
        b=jax.device_put(padded.b, sharding),
        Z=jax.device_put(padded.Z, sharding),
        weight=jax.device_put(padded.weight, sharding),
    )


def _local_normal_equations(Twc, edges: PoseGraphEdges, huber_delta: float, K: int):
    """H, g, cost from this shard's edges (runs per device under shard_map)."""
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

    H = jnp.zeros((K, 6, K, 6), dtype=Twc.dtype)
    H = H.at[edges.a, :, edges.a, :].add(Haa)
    H = H.at[edges.b, :, edges.b, :].add(Hbb)
    H = H.at[edges.a, :, edges.b, :].add(Hab)
    H = H.at[edges.b, :, edges.a, :].add(jnp.swapaxes(Hab, -1, -2))
    g = jnp.zeros((K, 6), dtype=Twc.dtype)
    g = g.at[edges.a].add(ga)
    g = g.at[edges.b].add(gb)
    return H.reshape(K * 6, K * 6), g.reshape(K * 6), cost


def distributed_pose_graph_optimize(
    Twc: jnp.ndarray,
    edges: PoseGraphEdges,
    fixed: jnp.ndarray,
    mesh: Mesh,
    iterations: int = 10,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Edge-sharded Levenberg-Marquardt: identical math to
    solvers.pose_graph.optimize_pose_graph, with the per-edge work SPMD over
    the mesh and H/g (and the accept/reject costs) reduced via psum over ICI.

    Twc (K,4,4) and fixed (K,) are replicated; edges are sharded on `axis`
    (see shard_edges). Returns (Twc_opt, final_cost).
    """
    K = Twc.shape[0]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), PoseGraphEdges(P(axis), P(axis), P(axis), P(axis)), P()),
        out_specs=(P(), P()),
    )
    def run(Twc0, ed, fixed_m):
        def lm_iter(_, state):
            Twc_cur, lam, _prev = state
            H, g, cost = _local_normal_equations(Twc_cur, ed, huber_delta, K)
            # ICI all-reduce of the normal equations
            H = jax.lax.psum(H, axis)
            g = jax.lax.psum(g, axis)
            cost = jax.lax.psum(cost, axis)

            diag_boost = jnp.where(jnp.repeat(fixed_m, 6), 1e9, lam + 1e-8)
            H = H + jnp.diag(diag_boost) + lam * jnp.diag(jnp.diag(H))
            xi = -jnp.linalg.solve(H, g).reshape(K, 6)
            xi = jnp.where(fixed_m[:, None], 0.0, xi)
            Twc_cand = se3.exp(xi) @ Twc_cur
            if not adaptive:
                return (Twc_cand, lam, cost)
            cost_new = jax.lax.psum(
                _local_graph_cost(Twc_cand, ed, huber_delta), axis)
            accept = cost_new < cost
            Twc_next, lam_next, cost_next = _lm_update(
                accept, lam, cost, cost_new, Twc_cur, Twc_cand)
            return (Twc_next, lam_next, cost_next)

        T_opt, _lam, cost = jax.lax.fori_loop(
            0, iterations, lm_iter,
            (Twc0, jnp.asarray(lm_lambda0, Twc0.dtype),
             jnp.asarray(jnp.inf, Twc0.dtype)),
        )
        return T_opt, cost

    return jax.jit(run)(Twc, edges, fixed)


@functools.lru_cache(maxsize=64)
def _dist_pg_cg_program(
    mesh: Mesh,
    K: int,
    iterations: int,
    cg_iters: int,
    huber_delta: float,
    lm_lambda0: float,
    axis: str,
    adaptive: bool,
):
    """Build-and-cache the jitted shard_map program for
    distributed_pose_graph_optimize_cg. The live backend calls the solve once
    per loop closure; without this cache each call would wrap a fresh Python
    closure in jax.jit and re-trace (seconds) every time."""
    return _make_dist_pg_cg(mesh, K, iterations, cg_iters, huber_delta,
                            lm_lambda0, axis, adaptive)


def distributed_pose_graph_optimize_cg(
    Twc: jnp.ndarray,
    edges: PoseGraphEdges,
    fixed: jnp.ndarray,
    mesh: Mesh,
    iterations: int = 10,
    cg_iters: int = 50,
    huber_delta: float = 1.0,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Edge-sharded Levenberg-Marquardt with a *distributed matrix-free CG*
    solve (adaptive lambda + masked step accept/reject; one extra (1,) psum
    per iteration for the candidate cost).

    Unlike distributed_pose_graph_optimize above, the (6K)^2 Hessian is never
    materialized (neither locally nor in the psum): each device holds only its
    edge shard's 6x6 blocks and the replicated O(K) vectors. Per GN iteration
    the collectives are one (K,6,6) psum (block-Jacobi preconditioner) and one
    (K,6) psum (gradient); per CG iteration exactly one (K,6) psum (the
    matvec) — 24K bytes/iter over ICI vs the dense variant's 144K^2. This is
    the solve that scales past ~1k keyframes (VERDICT round 1, item 1;
    distributing /root/reference/Solver/PoseGraph.cpp:350-368's backend solve).
    """
    prog = _dist_pg_cg_program(mesh, Twc.shape[0], iterations, cg_iters,
                               huber_delta, lm_lambda0, axis, adaptive)
    return prog(Twc, edges, fixed)


def _make_dist_pg_cg(mesh, K, iterations, cg_iters, huber_delta, lm_lambda0,
                     axis, adaptive):
    from rgbdslam.solvers.cg import _edge_blocks, pcg

    dtype = jnp.float32
    eye6 = jnp.eye(6, dtype=dtype)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), PoseGraphEdges(P(axis), P(axis), P(axis), P(axis)), P()),
        out_specs=(P(), P()),
    )
    def run(Twc0, ed, fixed_m):
        a_idx, b_idx = ed.a, ed.b
        fixed_f = fixed_m[:, None].astype(dtype)

        def lm_iter(_, state):
            Twc_cur, lam, _prev = state
            Haa, Hbb, Hab, ga, gb, cost = _edge_blocks(Twc_cur, ed, huber_delta)
            cost = jax.lax.psum(cost, axis)

            # block-Jacobi preconditioner from the (psum-reduced) diagonal
            D = jnp.zeros((K, 6, 6), dtype=dtype)
            D = D.at[a_idx].add(Haa)
            D = D.at[b_idx].add(Hbb)
            D = jax.lax.psum(D, axis)
            D = D + lam * eye6 + (fixed_f[..., None] * 1e9) * eye6
            D_inv = jnp.linalg.inv(D)

            g = jnp.zeros((K, 6), dtype=dtype)
            g = g.at[a_idx].add(ga)
            g = g.at[b_idx].add(gb)
            g = jax.lax.psum(g, axis)

            def H_mv(x):
                """Replicated (K,6) -> (K,6): local edge-block matvec,
                one psum. Gauge/damping terms added once, post-reduction."""
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
                y = jax.lax.psum(y, axis)
                return y + lam * x + (fixed_f * 1e9) * x

            def M_inv(x):
                return jnp.einsum("kij,kj->ki", D_inv, x)

            xi = pcg(H_mv, M_inv, -g, cg_iters)
            xi = jnp.where(fixed_m[:, None], 0.0, xi)
            Twc_cand = se3.exp(xi) @ Twc_cur
            if not adaptive:
                return (Twc_cand, lam, cost)
            cost_new = jax.lax.psum(
                _local_graph_cost(Twc_cand, ed, huber_delta), axis)
            accept = cost_new < cost
            Twc_next, lam_next, cost_next = _lm_update(
                accept, lam, cost, cost_new, Twc_cur, Twc_cand)
            return (Twc_next, lam_next, cost_next)

        T_opt, _lam, cost = jax.lax.fori_loop(
            0, iterations, lm_iter,
            (Twc0, jnp.asarray(lm_lambda0, dtype),
             jnp.asarray(jnp.inf, dtype)),
        )
        return T_opt, cost

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Distributed landmark-Schur bundle adjustment: landmark blocks sharded
# ---------------------------------------------------------------------------


def shard_landmarks(problem, mesh: Mesh, axis: str = "edges"):
    """Pad the BAProblem's landmark axis to a mesh multiple and device_put
    the landmark-major tables with landmark sharding (keyframe-axis arrays
    stay replicated). Padding slots are lm_valid=False."""
    n_dev = mesh.shape[axis]
    L = problem.Xw.shape[0]
    Lp = ((L + n_dev - 1) // n_dev) * n_dev
    pad = Lp - L

    def pad_lm(x, fill=0):
        if pad == 0:
            return x
        pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width, constant_values=fill)

    lm_shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return type(problem)(
        Tcw=jax.device_put(problem.Tcw, rep),
        Xw=jax.device_put(pad_lm(problem.Xw), lm_shard),
        lm_valid=jax.device_put(pad_lm(problem.lm_valid, False), lm_shard),
        obs_kf=jax.device_put(pad_lm(problem.obs_kf), lm_shard),
        obs_uv=jax.device_put(pad_lm(problem.obs_uv), lm_shard),
        obs_valid=jax.device_put(pad_lm(problem.obs_valid, False), lm_shard),
        obs_z=jax.device_put(pad_lm(problem.obs_z), lm_shard),
    )


def distributed_local_ba(
    cam,
    problem,
    fixed_kf: jnp.ndarray,
    mesh: Mesh,
    iterations: int = 5,
    huber_delta: float = 2.45,
    lm_lambda0: float = 1e-4,
    axis: str = "edges",
    adaptive: bool = True,
    edges=None,
    edge_huber: float = 1.0,
):
    """Landmark-sharded Schur-complement Levenberg-Marquardt BA
    (solvers/ba.local_ba, SPMD).

    Each device owns an L/n-shard of the landmark blocks: residuals,
    Jacobians, the 3x3 landmark eliminations, and its partial reduced camera
    system S (6K x 6K, K = window size, small) which is psum-reduced over the
    mesh; every device then solves the identical reduced system and
    back-substitutes its own landmarks locally — zero per-landmark
    communication. Per GN iteration the wire cost is one (6K)^2 + 6K psum.

    `edges` (solvers.ba.BAEdges, replicated) folds the pose-graph relative
    factors into the reduced camera system, as local_ba's joint mode — each
    device computes the identical edge blocks and adds them AFTER the psum
    (E << L, so replicating the edge work is cheaper than a second shard
    axis). This is what the live _global_ba dispatches to on a mesh.
    """
    prog = _dist_local_ba_program(
        mesh, cam, problem.Tcw.shape[0], iterations, huber_delta,
        lm_lambda0, axis, adaptive, edges is not None, edge_huber)
    if edges is not None:
        return prog(problem, fixed_kf, edges)
    return prog(problem, fixed_kf)


@functools.lru_cache(maxsize=64)
def _dist_local_ba_program(mesh, cam, K, iterations, huber_delta, lm_lambda0,
                           axis, adaptive, has_edges, edge_huber):
    """Cached jitted shard_map program for distributed_local_ba (the live
    _global_ba calls this after every loop closure; re-wrapping a fresh
    closure in jax.jit would re-trace every time)."""
    from rgbdslam.solvers.ba import (BAEdges, BAProblem, _ba_cost,
                                     _edge_residual_jacobians,
                                     _reproj_jacobians)
    from rgbdslam.solvers.ransac_se3 import _inv3x3

    dtype = jnp.float32
    pb_spec = BAProblem(P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                        P(axis))
    in_specs = (pb_spec, P())
    if has_edges:
        in_specs = in_specs + (BAEdges(P(), P(), P(), P()),)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P(axis), P()),
    )
    def run(pb, fixed_m, *maybe_edges):
        ed = maybe_edges[0] if has_edges else None
        L, M = pb.obs_kf.shape

        def edge_terms(Tcw):
            """Replicated relative-pose factor blocks (H_e, g_e, cost_e)."""
            r_e, Ja, Jb = jax.vmap(_edge_residual_jacobians)(
                Tcw[ed.a], Tcw[ed.b], ed.Z)
            rn_e = jnp.linalg.norm(r_e, axis=-1)
            hub = jnp.where(rn_e > edge_huber,
                            edge_huber / jnp.maximum(rn_e, 1e-9), 1.0)
            we = (ed.w * hub)[:, None, None]
            He = jnp.zeros((K, 6, K, 6), dtype=dtype)
            He = He.at[ed.a, :, ed.a, :].add(
                we * jnp.einsum("eri,erj->eij", Ja, Ja))
            He = He.at[ed.a, :, ed.b, :].add(
                we * jnp.einsum("eri,erj->eij", Ja, Jb))
            He = He.at[ed.b, :, ed.a, :].add(
                we * jnp.einsum("eri,erj->eij", Jb, Ja))
            He = He.at[ed.b, :, ed.b, :].add(
                we * jnp.einsum("eri,erj->eij", Jb, Jb))
            ge = jnp.zeros((K, 6), dtype=dtype)
            ge = ge.at[ed.a].add(we[:, :, 0] * jnp.einsum("eri,er->ei", Ja, r_e))
            ge = ge.at[ed.b].add(we[:, :, 0] * jnp.einsum("eri,er->ei", Jb, r_e))
            cost_e = _huber_cost(rn_e, ed.w, edge_huber)
            return He, ge, cost_e

        def lm_iter(_, state):
            Tcw, Xw, lam, _prev = state
            Tcw_o = Tcw[pb.obs_kf]
            uvz_hat, Jc, Jl, inv_sigma_z = _reproj_jacobians(
                cam, Tcw_o, Xw[:, None, :]
            )
            z = uvz_hat[..., 2]
            meas = jnp.concatenate([pb.obs_uv, pb.obs_z[..., None]], axis=-1)
            r = uvz_hat - meas
            has_z = pb.obs_z > 0
            sz = jnp.where(has_z, inv_sigma_z, 0.0)
            scale = jnp.stack(
                [jnp.ones_like(sz), jnp.ones_like(sz), sz], axis=-1
            )
            r = r * scale
            Jc_s = Jc * scale[..., None]
            Jl_s = Jl * scale[..., None]

            ok0 = pb.obs_valid & pb.lm_valid[:, None] & (z > 0.05)
            r_norm = jnp.linalg.norm(r, axis=-1)
            ok = ok0 & (r_norm < 10.0 * huber_delta)
            w_h = jnp.where(
                r_norm > huber_delta,
                huber_delta / jnp.maximum(r_norm, 1e-9),
                1.0,
            )
            w = w_h * ok.astype(dtype)
            # accept/reject cost matches _ba_cost (un-pruned Huber objective)
            cost = jax.lax.psum(
                _huber_cost(r_norm, ok0.astype(dtype), huber_delta), axis)

            Hll = jnp.einsum("lmri,lmrj,lm->lij", Jl_s, Jl_s, w)
            Hll = Hll + (lam + 1e-6) * jnp.eye(3, dtype=dtype)
            bl = jnp.einsum("lmri,lmr,lm->li", Jl_s, r, w)
            Hll_inv = _inv3x3(Hll)

            Hcc_o = jnp.einsum("lmri,lmrj,lm->lmij", Jc_s, Jc_s, w)
            bc_o = jnp.einsum("lmri,lmr,lm->lmi", Jc_s, r, w)
            G = jnp.einsum("lmri,lmrj,lm->lmij", Jc_s, Jl_s, w)

            kf = pb.obs_kf
            H = jnp.zeros((K, 6, K, 6), dtype=dtype)
            H = H.at[kf, :, kf, :].add(Hcc_o)
            g = jnp.zeros((K, 6), dtype=dtype).at[kf].add(bc_o)

            GHinv = jnp.einsum("lmij,ljk->lmik", G, Hll_inv)
            S_blocks = jnp.einsum("laij,lbkj->labik", GHinv, G)
            kf_a = jnp.broadcast_to(kf[:, :, None], (L, M, M))
            kf_b = jnp.broadcast_to(kf[:, None, :], (L, M, M))
            H = H.at[kf_a, :, kf_b, :].add(-S_blocks)
            g_red_o = jnp.einsum("lmik,lk->lmi", GHinv, bl)
            g = g.at[kf].add(-g_red_o)

            # reduce the (small) camera system over the landmark shards
            H = jax.lax.psum(H, axis)
            g = jax.lax.psum(g, axis)

            if has_edges:
                # relative-pose factors, identical on every device — added
                # once, after the landmark-shard reduction
                He, ge, cost_e = edge_terms(Tcw)
                H = H + He
                g = g + ge
                cost = cost + cost_e

            Hm = H.reshape(K * 6, K * 6)
            gv = g.reshape(K * 6)
            diag_boost = jnp.where(jnp.repeat(fixed_m, 6), 1e9, lam + 1e-8)
            Hm = Hm + jnp.diag(diag_boost) + lam * jnp.diag(jnp.diag(Hm))
            xi = -jnp.linalg.solve(Hm, gv).reshape(K, 6)
            xi = jnp.where(fixed_m[:, None], 0.0, xi)

            Gt_xi = jnp.einsum("lmij,lmi->lj", G, xi[kf])
            dX = -jnp.einsum("lij,lj->li", Hll_inv, bl + Gt_xi)
            obs_cnt = jnp.sum(w, axis=1)
            dX = jnp.where((pb.lm_valid & (obs_cnt > 0))[:, None], dX, 0.0)
            Tcw_cand = se3.exp(xi) @ Tcw
            Xw_cand = Xw + dX
            if not adaptive:
                return (Tcw_cand, Xw_cand, lam, cost)
            # candidate cost: local-shard residual pass + one scalar psum
            # (each shard's pb carries a scale-less local BAProblem view, so
            # _ba_cost evaluates this shard's landmarks only)
            cost_new = jax.lax.psum(
                _ba_cost(cam, Tcw_cand, Xw_cand, pb, huber_delta, None, 1.0),
                axis)
            if has_edges:
                cost_new = cost_new + edge_terms(Tcw_cand)[2]
            accept = cost_new < cost
            (Tcw_next, Xw_next), lam_next, cost_next = _lm_update(
                accept, lam, cost, cost_new, (Tcw, Xw), (Tcw_cand, Xw_cand))
            return (Tcw_next, Xw_next, lam_next, cost_next)

        Tcw_o, Xw_o, _lam, cost = jax.lax.fori_loop(
            0, iterations, lm_iter,
            (pb.Tcw, pb.Xw, jnp.asarray(lm_lambda0, dtype),
             jnp.asarray(jnp.inf, dtype)),
        )
        return Tcw_o, Xw_o, cost

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Data-parallel frontend: batch of frames sharded across devices
# ---------------------------------------------------------------------------


def batched_frontend(cam, cfg):
    """Returns a jitted fn (grays [B,H,W], depths [B,H,W]) -> FrameFeatures
    batch, to be invoked with B-sharded inputs; XLA partitions the whole
    pipeline (pyramid/FAST/descriptors) per device with zero collectives —
    the P5 OpenMP-grid analog at chip granularity."""
    from rgbdslam.frontend.frame import build_frame_features

    def run(grays, depths):
        return jax.vmap(lambda g, d: build_frame_features(cam, g, d, cfg))(
            grays, depths
        )

    return jax.jit(run)
