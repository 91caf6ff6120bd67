"""Sim(3) math + scale-drift-aware pose-graph tests."""

import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.geometry import se3, sim3
from rgbdslam.solvers.pose_graph import (
    PoseGraphEdges,
    optimize_sim3_graph,
    sim3_edge_residual,
)


def rand_xi7(rng, t=0.5, r=0.5, s=0.3):
    return np.concatenate([
        rng.normal(scale=t, size=3),
        ScipyRot.random(random_state=int(rng.integers(1 << 30))).as_rotvec()
        * rng.uniform(0, r) / np.pi,
        [rng.normal(scale=s)],
    ]).astype(np.float32)


def test_sim3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    xi = np.stack([rand_xi7(rng) for _ in range(32)])
    S = sim3.exp(jnp.asarray(xi))
    xi_rt = np.asarray(sim3.log(S))
    np.testing.assert_allclose(xi_rt, xi, atol=2e-3)


def test_sim3_reduces_to_se3_at_zero_scale():
    rng = np.random.default_rng(1)
    xi7 = rand_xi7(rng, s=0.0)
    xi7[6] = 0.0
    S = np.asarray(sim3.exp(jnp.asarray(xi7)))
    T = np.asarray(se3.exp(jnp.asarray(xi7[:6])))
    np.testing.assert_allclose(S, T, atol=1e-5)


def test_sim3_scale_action():
    xi = jnp.asarray(np.r_[0, 0, 0, 0, 0, 0, np.log(2.0)].astype(np.float32))
    S = sim3.exp(xi)
    assert abs(float(sim3.scale_of(S)) - 2.0) < 1e-5
    pts = jnp.asarray(np.array([[1.0, 2.0, 3.0]], np.float32))
    out = np.asarray(sim3.transform_points(S, pts))
    np.testing.assert_allclose(out, [[2.0, 4.0, 6.0]], atol=1e-5)


def test_sim3_inverse():
    rng = np.random.default_rng(2)
    S = sim3.exp(jnp.asarray(rand_xi7(rng)))
    I = np.asarray(S @ sim3.inverse(S))
    np.testing.assert_allclose(I, np.eye(4), atol=1e-5)


def test_sim3_edge_residual_zero_when_consistent():
    rng = np.random.default_rng(3)
    Sa = sim3.exp(jnp.asarray(rand_xi7(rng)))
    Sb = sim3.exp(jnp.asarray(rand_xi7(rng)))
    Z = sim3.inverse(Sa) @ Sb
    r = np.asarray(sim3_edge_residual(Sa, Sb, Z))
    np.testing.assert_allclose(r, 0.0, atol=1e-5)


def test_sim3_graph_corrects_scale_drift():
    """Chain whose odometry measurements carry a per-step scale bias; a
    scale-true loop edge at the end redistributes the drift (the classic
    monocular scale-drift loop-closure scenario)."""
    rng = np.random.default_rng(4)
    n = 10
    # ground truth: unit-scale poses along a line
    gt = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [i * 0.5, 0, 0]
        gt.append(T)

    # drifting estimate: each step multiplies scale by 1.05
    est = [gt[0].copy()]
    for i in range(1, n):
        xi = np.zeros(7, np.float32)
        xi[0] = 0.5
        xi[6] = np.log(1.05)
        step = np.asarray(sim3.exp(jnp.asarray(xi)))
        est.append((est[-1] @ step).astype(np.float32))
    scale_end_before = float(sim3.scale_of(jnp.asarray(est[-1])))
    assert scale_end_before > 1.4  # drift accumulated

    a, b, Z, w = [], [], [], []
    for i in range(1, n):
        a.append(i), b.append(i - 1)
        Z.append(np.asarray(sim3.inverse(jnp.asarray(est[i])) @ jnp.asarray(est[i - 1])))
        w.append(100.0)
    # loop edge with the TRUE (unit-scale) relative transform
    a.append(n - 1), b.append(0)
    Z.append(np.asarray(sim3.inverse(jnp.asarray(gt[-1])) @ jnp.asarray(gt[0])))
    w.append(100.0)

    edges = PoseGraphEdges(
        a=jnp.asarray(np.asarray(a, np.int32)),
        b=jnp.asarray(np.asarray(b, np.int32)),
        Z=jnp.asarray(np.stack(Z).astype(np.float32)),
        weight=jnp.asarray(np.asarray(w, np.float32)),
    )
    fixed = jnp.zeros((n,), bool).at[0].set(True)
    S_opt, cost = optimize_sim3_graph(
        jnp.asarray(np.stack(est)), edges, fixed, iterations=20
    )
    scale_end_after = float(sim3.scale_of(S_opt[-1]))
    # loop edge pulls the endpoint scale back toward 1
    assert abs(np.log(scale_end_after)) < 0.6 * abs(np.log(scale_end_before))
    assert np.isfinite(float(cost))
