"""Distributed (shard_map) tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyRot

from rgbdslam.geometry import se3
from rgbdslam.parallel.dist_ba import (
    distributed_pose_graph_optimize,
    make_mesh,
    shard_edges,
)
from rgbdslam.solvers.pose_graph import PoseGraphEdges, optimize_pose_graph


def _chain_problem(rng, n=10):
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = ScipyRot.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix()
        d[:3, 3] = rng.normal(scale=0.3, size=3)
        gt.append((gt[-1] @ d).astype(np.float32))
    est = [gt[0]]
    for i in range(1, n):
        noise = np.asarray(se3.exp(jnp.asarray(rng.normal(scale=0.05, size=6).astype(np.float32))))
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
    return np.stack(gt), np.stack(est), edges


def test_eight_devices_available():
    assert jax.device_count() >= 8


def test_distributed_matches_single_device():
    """Edge-sharded optimization must produce the same result as the
    single-device solver (identical math, psum-reduced)."""
    rng = np.random.default_rng(0)
    gt, est, edges = _chain_problem(rng, n=10)
    fixed = jnp.zeros((10,), bool).at[0].set(True)

    T_single, cost_s = optimize_pose_graph(jnp.asarray(est), edges, fixed, 10, 1.0)

    mesh = make_mesh(8)
    edges_sh = shard_edges(edges, mesh)
    T_dist, cost_d = distributed_pose_graph_optimize(
        jnp.asarray(est), edges_sh, fixed, mesh, iterations=10
    )
    np.testing.assert_allclose(np.asarray(T_dist), np.asarray(T_single), atol=1e-4)


def test_distributed_converges_to_gt():
    rng = np.random.default_rng(1)
    gt, est, edges = _chain_problem(rng, n=12)
    fixed = jnp.zeros((12,), bool).at[0].set(True)
    mesh = make_mesh(8)
    T_dist, _ = distributed_pose_graph_optimize(
        jnp.asarray(est), shard_edges(edges, mesh), fixed, mesh, iterations=15
    )
    out = np.asarray(T_dist)
    for i in range(12):
        err = np.linalg.inv(out[i]) @ gt[i]
        assert float(se3.translation_norm(jnp.asarray(err))) < 1e-2
        assert float(se3.rotation_angle(jnp.asarray(err))) < 1e-2


def test_distributed_cg_matches_single_device():
    """The edge-sharded matrix-free-CG solve (O(K) per-device state) matches
    the single-device dense Cholesky on the same graph."""
    from rgbdslam.parallel.dist_ba import distributed_pose_graph_optimize_cg

    rng = np.random.default_rng(2)
    gt, est, edges = _chain_problem(rng, n=12)
    fixed = jnp.zeros((12,), bool).at[0].set(True)
    T_single, _ = optimize_pose_graph(jnp.asarray(est), edges, fixed, 8, 1.0)
    mesh = make_mesh(8)
    T_cg, cost = distributed_pose_graph_optimize_cg(
        jnp.asarray(est), shard_edges(edges, mesh), fixed, mesh,
        iterations=8, cg_iters=64,
    )
    np.testing.assert_allclose(np.asarray(T_cg), np.asarray(T_single), atol=2e-3)
    assert np.isfinite(float(cost))


def test_distributed_local_ba_matches_unsharded():
    """Landmark-sharded Schur BA equals the single-device local_ba and
    reduces pose error on a noisy multi-view problem."""
    from test_ba import CAM, make_problem, pose_errs

    from rgbdslam.parallel.dist_ba import (distributed_local_ba,
                                           shard_landmarks)
    from rgbdslam.solvers.ba import local_ba

    rng = np.random.default_rng(3)
    problem, Tcw_gt, _ = make_problem(rng, K=6, L=64, M=6)
    fixed = jnp.zeros((6,), bool).at[0].set(True)

    Tcw_ref, Xw_ref, _ = local_ba(CAM, problem, fixed, 5)

    mesh = make_mesh(8)
    pb = shard_landmarks(problem, mesh)
    Tcw_d, Xw_d, cost = distributed_local_ba(CAM, pb, fixed, mesh, 5)

    np.testing.assert_allclose(np.asarray(Tcw_d), np.asarray(Tcw_ref),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(Xw_d)[:64], np.asarray(Xw_ref),
                               atol=1e-3)
    before = pose_errs(np.asarray(problem.Tcw), Tcw_gt).max()
    after = pose_errs(np.asarray(Tcw_d), Tcw_gt).max()
    assert after < before


def test_graft_dryrun_multichip():
    """The driver's multi-chip dry run must work on the CPU mesh."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_graft_entry_compiles():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == (4, 4)


def test_pipelined_odometry_matches_tracker():
    """The scan-pipelined odometry produces a trajectory consistent with the
    per-frame Tracker on the same frames (no backend, same estimator)."""
    import numpy as np

    from rgbdslam.config import ExtractorConfig, SlamConfig
    from rgbdslam.eval.ate import ate_rmse
    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.slam.pipeline import PipelinedOdometry

    cam = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
    cfg = SlamConfig(
        extractor=ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                                  fast_threshold=15.0)
    )
    # 30 frames keeps inter-frame motion moderate (the pipeline has no
    # second-reference retry)
    ds = SyntheticDataset(n_frames=30, cam=cam, trajectory="sweep")
    pipe = PipelinedOdometry(cam, cfg, batch=8)
    ts, poses, stats = pipe.run(ds.grab(i) for i in range(len(ds)))
    assert stats["frames"] == 30
    rmse, info = ate_rmse(ts, poses, ds.timestamps, ds.poses_twc)
    assert rmse < 0.06, f"pipelined ATE {rmse}"


def test_dp_odometry_matches_unsharded():
    """Sequence-sharded odometry over the 8-device mesh equals the
    unsharded vmap computation and recovers the synthetic motion."""
    import jax
    import jax.numpy as jnp

    from rgbdslam.config import ExtractorConfig, SlamConfig
    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.parallel.dp_odometry import (compose_chain, dp_odometry,
                                               make_seq_mesh,
                                               _sequence_odometry)

    cam = Camera(100.0, 100.0, 79.5, 59.5, width=160, height=120)
    cfg = SlamConfig(extractor=ExtractorConfig(
        num_features=256, num_levels=2, cell_size=8, fast_threshold=10.0,
        min_response=5.0, min_border=16))
    S, T = 8, 5
    grays, depths = [], []
    for s in range(S):
        ds = SyntheticDataset(n_frames=T, cam=cam, trajectory="sweep",
                              seed=s)
        g = jnp.stack([ds.grab(i)[1] for i in range(T)])
        d = jnp.stack([ds.grab(i)[2] for i in range(T)])
        grays.append(g)
        depths.append(d)
    grays = jnp.stack(grays)
    depths = jnp.stack(depths)
    keys = jax.random.split(jax.random.PRNGKey(0), S)

    mesh = make_seq_mesh(8)
    T21_dp, ninl_dp = jax.device_get(
        dp_odometry(cam, cfg, mesh)(grays, depths, keys))

    seq_fn = _sequence_odometry(cam, cfg)
    T21_ref, ninl_ref = jax.device_get(
        jax.jit(jax.vmap(seq_fn))(grays, depths, keys))

    np.testing.assert_allclose(T21_dp, T21_ref, atol=1e-4)
    np.testing.assert_array_equal(ninl_dp, ninl_ref)

    # sanity: chains compose into finite trajectories with inliers found
    traj = compose_chain(T21_dp)
    assert np.isfinite(traj).all()
    assert (ninl_dp > 10).mean() > 0.8
