"""Pose-graph optimizer tests: residual conventions, noise reduction, loop
closure correction on a drifting circle."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.geometry import se3
from rgbdslam.solvers.pose_graph import PoseGraph, edge_residual


def _rand_T(rng, t_scale=1.0, r_scale=0.5):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.from_rotvec(rng.normal(scale=r_scale, size=3)).as_matrix()
    T[:3, 3] = rng.normal(scale=t_scale, size=3)
    return T


def test_edge_residual_zero_for_consistent_measurement():
    rng = np.random.default_rng(0)
    Ta, Tb = _rand_T(rng), _rand_T(rng)
    Z = np.linalg.inv(Ta) @ Tb
    r = np.asarray(edge_residual(jnp.asarray(Ta), jnp.asarray(Tb), jnp.asarray(Z)))
    np.testing.assert_allclose(r, 0.0, atol=1e-5)


def test_chain_converges_to_measurements():
    """A noisy chain with exact odometry measurements snaps onto the
    measurement-consistent trajectory (anchored at vertex 0)."""
    rng = np.random.default_rng(1)
    n = 12
    # ground-truth trajectory
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        delta = np.eye(4, dtype=np.float32)
        delta[:3, :3] = ScipyRot.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix()
        delta[:3, 3] = rng.normal(scale=0.3, size=3)
        gt.append((gt[-1] @ delta).astype(np.float32))

    g = PoseGraph(max_vertices=32, max_edges=64)
    for i in range(n):
        # corrupt initial estimates (except anchor)
        T0 = gt[i].copy()
        if i > 0:
            noise = se3.exp(jnp.asarray(rng.normal(scale=0.05, size=6).astype(np.float32)))
            T0 = np.asarray(noise) @ T0
        g.add_vertex(T0)
    for i in range(1, n):
        Z = np.linalg.inv(gt[i]) @ gt[i - 1]   # T_{i<-i-1} exact
        g.add_edge(i, i - 1, Z)
        # redundant skip-edges for rigidity
        if i >= 2:
            Z2 = np.linalg.inv(gt[i]) @ gt[i - 2]
            g.add_edge(i, i - 2, Z2)

    out = g.optimize(iterations=20)
    for i in range(n):
        err = np.linalg.inv(out[i]) @ gt[i]
        assert float(se3.translation_norm(jnp.asarray(err))) < 5e-3, i
        assert float(se3.rotation_angle(jnp.asarray(err))) < 5e-3, i


def test_loop_closure_redistributes_drift():
    """Circle trajectory with accumulated odometry drift + one loop edge:
    the endpoint gap must shrink by a large factor after optimization."""
    rng = np.random.default_rng(2)
    n = 24
    # ground truth: poses on a circle
    gt = []
    for i in range(n):
        a = 2 * np.pi * i / n
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = ScipyRot.from_rotvec([0, a, 0]).as_matrix()
        T[:3, 3] = [np.cos(a), 0.0, np.sin(a)]
        gt.append(T)

    # odometry with small bias -> drift
    est = [gt[0].copy()]
    odo = []
    for i in range(1, n):
        Z_true = np.linalg.inv(gt[i - 1]) @ gt[i]  # T_{i-1 -> i} as Twc delta
        noise = np.asarray(
            se3.exp(jnp.asarray((rng.normal(scale=0.01, size=6) + 0.015).astype(np.float32)))
        )
        Z_noisy = Z_true @ noise
        est.append((est[-1] @ Z_noisy).astype(np.float32))
        odo.append(Z_noisy)

    gap_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    assert gap_before > 0.05  # drift actually accumulated

    g = PoseGraph(max_vertices=32, max_edges=64)
    for T in est:
        g.add_vertex(T)
    for i in range(1, n):
        # edge convention: Z = T_{a<-b} with vertices' Twc: X_a^-1 X_b
        Z = np.linalg.inv(odo[i - 1])
        g.add_edge(i, i - 1, Z)
    # loop edge: last vertex sees the first with the TRUE relative transform
    Z_loop = np.linalg.inv(gt[-1]) @ gt[0]
    g.add_edge(n - 1, 0, Z_loop, weight=1.0)

    out = g.optimize(iterations=25)
    gap_after = np.linalg.norm(out[-1][:3, 3] - (out[0] @ np.linalg.inv(gt[0]) @ gt[-1])[:3, 3])
    # endpoint now consistent with the loop measurement
    r = np.asarray(
        edge_residual(jnp.asarray(out[-1]), jnp.asarray(out[0]), jnp.asarray(Z_loop))
    )
    # the single loop edge reaches equilibrium against 23 odometry edges of
    # equal information, so the residual is small but nonzero
    assert np.linalg.norm(r) < 0.05, f"loop residual {np.linalg.norm(r)}"
    # and drift redistributed: mean error to gt drops
    err_before = np.mean([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(est, gt)])
    err_after = np.mean([np.linalg.norm(e[:3, 3] - t[:3, 3]) for e, t in zip(out, gt)])
    assert err_after < 0.6 * err_before, (err_before, err_after)


def test_edge_dedup_and_gates():
    g = PoseGraph(max_vertices=16, max_edges=16)
    for _ in range(6):
        g.add_vertex(np.eye(4, dtype=np.float32))
    g.add_edge(1, 0, np.eye(4, dtype=np.float32))
    assert g.has_edge(1, 0) and g.has_edge(0, 1)  # existEdge symmetry
    assert g.has_edge(3, 3)                        # self-edge always "exists"
    assert not g.has_edge(2, 0)


def test_optimize_requires_min_vertices():
    """>5 vertices gate (Solver/PoseGraph.cpp:354)."""
    g = PoseGraph(max_vertices=8, max_edges=8)
    for i in range(4):
        g.add_vertex(np.eye(4, dtype=np.float32))
    out = g.optimize()
    assert out.shape == (4, 4, 4)  # unchanged passthrough


def test_cg_matches_dense_solver():
    """Matrix-free PCG Gauss-Newton converges to the same optimum as the
    dense Cholesky solver."""
    from rgbdslam.solvers.cg import optimize_pose_graph_cg
    from rgbdslam.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph

    rng = np.random.default_rng(11)
    n = 16
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = ScipyRot.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix()
        d[:3, 3] = rng.normal(scale=0.3, size=3)
        gt.append((gt[-1] @ d).astype(np.float32))
    est = [gt[0]]
    for i in range(1, n):
        noise = np.asarray(se3.exp(jnp.asarray(
            rng.normal(scale=0.05, size=6).astype(np.float32))))
        est.append((noise @ gt[i]).astype(np.float32))
    a, b, Z = [], [], []
    for i in range(1, n):
        a.append(i), b.append(i - 1), Z.append(np.linalg.inv(gt[i]) @ gt[i - 1])
        if i >= 2:
            a.append(i), b.append(i - 2), Z.append(np.linalg.inv(gt[i]) @ gt[i - 2])
    edges = PoseGraphEdges(
        a=jnp.asarray(np.asarray(a, np.int32)),
        b=jnp.asarray(np.asarray(b, np.int32)),
        Z=jnp.asarray(np.stack(Z).astype(np.float32)),
        weight=jnp.full((len(a),), 100.0, jnp.float32),
    )
    fixed = jnp.zeros((n,), bool).at[0].set(True)
    est_j = jnp.asarray(np.stack(est))

    T_dense, _ = optimize_pose_graph(est_j, edges, fixed, 12, 1.0)
    T_cg, _ = optimize_pose_graph_cg(est_j, edges, fixed, 12, 60, 1.0)
    for i in range(n):
        d = np.linalg.inv(np.asarray(T_cg)[i]) @ np.asarray(T_dense)[i]
        assert float(se3.translation_norm(jnp.asarray(d))) < 2e-3, i
        assert float(se3.rotation_angle(jnp.asarray(d))) < 2e-3, i


def test_live_pose_graph_switches_to_cg_above_threshold():
    """PoseGraph.optimize takes the matrix-free CG path once the padded
    vertex count crosses cg_threshold, and the result matches the dense
    solve on the identical graph (SURVEY.md §7 layer 7 'then Schur/CG')."""
    rng = np.random.default_rng(7)
    n = 40

    def build(cg_threshold):
        g = PoseGraph(max_vertices=64, max_edges=256,
                      cg_threshold=cg_threshold, cg_iters=80)
        gt = [np.eye(4, dtype=np.float32)]
        r = np.random.default_rng(7)
        for i in range(1, n):
            d = np.eye(4, dtype=np.float32)
            d[:3, :3] = ScipyRot.from_rotvec(r.normal(scale=0.08, size=3)).as_matrix()
            d[:3, 3] = r.normal(scale=0.25, size=3)
            gt.append((gt[-1] @ d).astype(np.float32))
        for i in range(n):
            T0 = gt[i].copy()
            if i > 0:
                noise = se3.exp(jnp.asarray(
                    r.normal(scale=0.04, size=6).astype(np.float32)))
                T0 = np.asarray(noise) @ T0
            g.add_vertex(T0)
        for i in range(1, n):
            g.add_edge(i, i - 1, np.linalg.inv(gt[i]) @ gt[i - 1])
            if i >= 3:
                g.add_edge(i, i - 3, np.linalg.inv(gt[i]) @ gt[i - 3])
        return g

    g_dense = build(cg_threshold=10**6)   # always dense
    g_cg = build(cg_threshold=8)          # padded K=64 >= 8 -> CG path
    out_dense = g_dense.optimize(iterations=15)
    out_cg = g_cg.optimize(iterations=15)
    for i in range(n):
        d = np.linalg.inv(out_cg[i]) @ out_dense[i]
        assert float(se3.translation_norm(jnp.asarray(d))) < 3e-3, i
        assert float(se3.rotation_angle(jnp.asarray(d))) < 3e-3, i
