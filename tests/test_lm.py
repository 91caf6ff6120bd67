"""Levenberg-Marquardt accept/reject tests (VERDICT r3 item 3).

The reference backend is g2o *Levenberg* (Solver/PoseGraph.cpp:30-57):
adaptive lambda with step accept/reject. These tests pin the LM behavior the
fixed-damping Gauss-Newton of rounds 1-3 lacked:

- a near-degenerate solve (low-parallax reprojection-only BA — landmark depth
  unconstrained, Hll near-singular) where fixed-damping GN *diverges* and LM
  converges;
- cost monotonicity of the accepted-step sequence;
- dense / matrix-free-CG / distributed LM variants agreeing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera
from rgbdslam.solvers.ba import BAProblem, _ba_cost, local_ba
from rgbdslam.solvers.cg import optimize_pose_graph_cg
from rgbdslam.solvers.pose_graph import (PoseGraphEdges, graph_cost,
                                         optimize_pose_graph)

CAM = Camera(fx=200.0, fy=200.0, cx=80.0, cy=60.0, width=160, height=120)


def _circle_graph(K=16, seed=0, init_scale=1.0):
    """Ground-truth circle graph + chain/loop edges + corrupted init."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, K, endpoint=False)
    T_gt = []
    for t in th:
        c, s = np.cos(t), np.sin(t)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        Tw = np.eye(4, dtype=np.float32)
        Tw[:3, :3] = R
        Tw[:3, 3] = [2 * np.cos(t), 0, 2 * np.sin(t)]
        T_gt.append(Tw)
    T_gt = np.stack(T_gt)
    ea, eb, eZ, ew = [], [], [], []
    for i in range(1, K):
        ea.append(i); eb.append(i - 1)
        eZ.append((np.linalg.inv(T_gt[i]) @ T_gt[i - 1]).astype(np.float32))
        ew.append(100.0)
    ea.append(K - 1); eb.append(0)
    eZ.append((np.linalg.inv(T_gt[K - 1]) @ T_gt[0]).astype(np.float32))
    ew.append(100.0)
    E = len(ea)
    Ep = 32
    sel = np.arange(Ep) < E
    edges = PoseGraphEdges(
        a=jnp.asarray(np.resize(np.array(ea, np.int32), Ep) * sel),
        b=jnp.asarray(np.resize(np.array(eb, np.int32), Ep) * sel),
        Z=jnp.asarray(np.concatenate(
            [np.stack(eZ),
             np.tile(np.eye(4, dtype=np.float32), (Ep - E, 1, 1))])),
        weight=jnp.asarray(np.concatenate(
            [np.array(ew, np.float32), np.zeros(Ep - E, np.float32)])),
    )
    xi = rng.normal(0, init_scale, (K, 6)).astype(np.float32)
    xi[0] = 0
    est = (np.asarray(jax.vmap(se3.exp)(jnp.asarray(xi))) @ T_gt).astype(
        np.float32)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    return jnp.asarray(est), edges, fixed


def _low_parallax_ba(seed=0):
    """Reprojection-only BA with a ~1 mm camera baseline: landmark depth is
    unconstrained (Hll near-singular along the ray) — the canonical problem
    where an (almost) undamped Gauss-Newton step explodes."""
    rng = np.random.default_rng(seed)
    K, L, M = 4, 32, 4
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    for k in range(K):
        Tcw[k, 0, 3] = 0.001 * k
    Xw = np.stack([rng.uniform(-0.5, 0.5, L), rng.uniform(-0.4, 0.4, L),
                   rng.uniform(1.5, 3.0, L)], 1).astype(np.float32)
    obs_kf = np.tile(np.arange(K, dtype=np.int32), (L, 1))
    obs_uv = np.zeros((L, M, 2), np.float32)
    for k in range(K):
        Xc = Xw @ Tcw[k, :3, :3].T + Tcw[k, :3, 3]
        obs_uv[:, k, 0] = (CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
                           + rng.normal(0, 0.5, L))
        obs_uv[:, k, 1] = (CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
                           + rng.normal(0, 0.5, L))
    X0 = Xw * rng.uniform(0.7, 1.4, (L, 1)).astype(np.float32)
    pb = BAProblem(
        Tcw=jnp.asarray(Tcw), Xw=jnp.asarray(X0),
        lm_valid=jnp.ones((L,), bool), obs_kf=jnp.asarray(obs_kf),
        obs_uv=jnp.asarray(obs_uv), obs_valid=jnp.ones((L, M), bool),
        obs_z=jnp.zeros((L, M), jnp.float32),
    )
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    return pb, fixed


def test_ba_gn_diverges_lm_converges():
    """The VERDICT r3 item-3 acceptance case: fixed-damping GN diverges on a
    near-singular-H solve; LM (adaptive=True, the default) converges."""
    pb, fixed = _low_parallax_ba()
    c0 = float(_ba_cost(CAM, pb.Tcw, pb.Xw, pb, 2.45, None, 1.0))
    Tg, Xg, _ = local_ba(CAM, pb, fixed, 20, 2.45, 1e-6, None, 1.0, False)
    Tl, Xl, _ = local_ba(CAM, pb, fixed, 20, 2.45, 1e-4, None, 1.0, True)
    c_gn = float(_ba_cost(CAM, Tg, Xg, pb, 2.45, None, 1.0))
    c_lm = float(_ba_cost(CAM, Tl, Xl, pb, 2.45, None, 1.0))
    assert c_gn > 10.0 * c0          # GN blew up (66 -> ~6e4 measured)
    assert c_lm < 0.5 * c0           # LM reduced the objective
    assert np.isfinite(np.asarray(Xl)).all()


def test_pose_graph_lm_cost_monotone():
    """Accepted-step costs are non-increasing (LM never keeps a step that
    raises the robust objective), and a corrupted circle init converges."""
    est, edges, fixed = _circle_graph(init_scale=1.5, seed=0)
    costs = []
    for it in (1, 2, 4, 8, 16):
        T_opt, _ = optimize_pose_graph(est, edges, fixed, it, 1.0, 1e-4)
        costs.append(float(graph_cost(T_opt, edges, 1.0)))
    for c_prev, c_next in zip(costs, costs[1:]):
        assert c_next <= c_prev * (1 + 1e-4)
    assert costs[-1] < 1e-3 * costs[0]


def test_pose_graph_lm_rejected_step_holds_pose():
    """With an absurdly large lambda floor the first solve is a tiny step;
    with a tiny lambda the step is near-Newton: both must keep the cost
    finite and never *increase* it (reject keeps the current estimate)."""
    est, edges, fixed = _circle_graph(init_scale=2.0, seed=5)
    c0 = float(graph_cost(est, edges, 1.0))
    for lam0 in (1e-8, 1e-4, 1e2):
        T_opt, _ = optimize_pose_graph(est, edges, fixed, 6, 1.0, lam0)
        c = float(graph_cost(T_opt, edges, 1.0))
        assert np.isfinite(c)
        assert c <= c0 * (1 + 1e-4)


def test_cg_lm_matches_dense_lm():
    est, edges, fixed = _circle_graph(init_scale=0.3, seed=7)
    T_dense, _ = optimize_pose_graph(est, edges, fixed, 10, 1.0, 1e-4)
    T_cg, _ = optimize_pose_graph_cg(est, edges, fixed, 10, 60, 1.0, 1e-4)
    c_dense = float(graph_cost(T_dense, edges, 1.0))
    c_cg = float(graph_cost(T_cg, edges, 1.0))
    assert c_dense < 1e-6 and c_cg < 1e-6
    np.testing.assert_allclose(np.asarray(T_cg), np.asarray(T_dense),
                               atol=5e-3)


def test_distributed_lm_matches_single():
    """The edge-sharded LM (the live distributed backend path) agrees with
    the single-device dense LM on the same problem."""
    from rgbdslam.parallel.dist_ba import (
        distributed_pose_graph_optimize_cg, make_mesh, shard_edges)

    if jax.device_count() < 2:
        pytest.skip("needs the virtual multi-device mesh")
    est, edges, fixed = _circle_graph(init_scale=0.3, seed=11)
    mesh = make_mesh()
    ed = shard_edges(edges, mesh)
    T_dist, cost = distributed_pose_graph_optimize_cg(
        est, ed, fixed, mesh, 10, 60, 1.0, 1e-4)
    T_dense, _ = optimize_pose_graph(est, edges, fixed, 10, 1.0, 1e-4)
    assert np.isfinite(float(cost))
    np.testing.assert_allclose(np.asarray(T_dist), np.asarray(T_dense),
                               atol=5e-3)


def test_lm_lambda0_field_is_live():
    """PoseGraphConfig.lm_lambda0 reaches the host PoseGraph (the field was
    defined-but-dead through round 3)."""
    from rgbdslam.config import SlamConfig
    from rgbdslam.solvers.pose_graph import PoseGraph

    cfg = SlamConfig()
    pg = PoseGraph(8, 8, lm_lambda0=cfg.pose_graph.lm_lambda0)
    assert pg.lm_lambda0 == cfg.pose_graph.lm_lambda0
