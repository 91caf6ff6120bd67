"""GICP loop kernel vs the XLA Gauss-Newton loop (interpret mode here; the
same kernel runs compiled in tests/test_gpu_kernels.py), and the XLA
Mahalanobis hypothesis scorer vs a float64 NumPy reference."""

import jax.numpy as jnp
import numpy as np
import pytest

import rgbdslam  # noqa: F401
from rgbdslam.config import IcpConfig, RansacConfig
from rgbdslam.geometry import se3
from rgbdslam.ops.pallas_kernels import gicp_refine_kernel
from rgbdslam.solvers import icp
from rgbdslam.solvers.ransac_se3 import _score, _sigma_diag


def _random_problem(rng, H=64, N=256):
    xi = rng.normal(scale=0.1, size=(H, 6)).astype(np.float32)
    T_h = np.asarray(se3.exp(jnp.asarray(xi)))
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] = rng.uniform(0.5, 4.0, N)
    T_true = np.asarray(se3.exp(jnp.asarray(
        rng.normal(scale=0.05, size=6).astype(np.float32))))
    p2 = (p1 @ T_true[:3, :3].T + T_true[:3, 3]
          + rng.normal(scale=0.005, size=(N, 3))).astype(np.float32)
    valid = rng.uniform(size=N) > 0.2
    return T_h, p1, p2, valid


def mahalanobis_scores_f64(T_h, p1, p2, valid, cfg):
    """(m2 (H, N), inlier counts (H,)) in float64: explicit 3x3 covariance
    C = R diag(s1) R^T + diag(s2) and a linear solve per pair."""
    p1, p2 = p1.astype(np.float64), p2.astype(np.float64)
    s1 = np.asarray(_sigma_diag(jnp.asarray(p1[:, 2]), cfg), np.float64)
    s2 = np.asarray(_sigma_diag(jnp.asarray(p2[:, 2]), cfg), np.float64)
    R = T_h[:, :3, :3].astype(np.float64)
    t = T_h[:, :3, 3].astype(np.float64)
    delta = np.einsum("hij,nj->hni", R, p1) + t[:, None, :] - p2[None]
    C = (np.einsum("hik,nk,hjk->hnij", R, s1, R)
         + s2[None, :, :, None] * np.eye(3))
    m2 = np.einsum("hni,hni->hn", delta,
                   np.linalg.solve(C, delta[..., None])[..., 0])
    th = cfg.max_mahalanobis ** 2
    return m2, ((m2 <= th) & valid[None]).sum(axis=1)


@pytest.mark.parametrize("H,N", [(64, 256), (256, 1024)])
def test_mahalanobis_scorer_matches_float64(H, N):
    """Inlier counts equal the float64 reference, except for pairs within
    1e-5 (relative) of the gate, where f32 rounding may decide either way."""
    cfg = RansacConfig()
    T_h, p1, p2, valid = _random_problem(np.random.default_rng(H + N), H, N)
    _inl, cnt, _rmse = _score(jnp.asarray(T_h), jnp.asarray(p1),
                              jnp.asarray(p2), jnp.asarray(valid), cfg)
    m2, cnt_ref = mahalanobis_scores_f64(T_h, p1, p2, valid, cfg)
    th = cfg.max_mahalanobis ** 2
    near = ((np.abs(m2 - th) <= 1e-5 * th) & valid[None]).sum(axis=1)
    assert (np.abs(np.asarray(cnt) - cnt_ref) <= near).all()
    assert cnt_ref.max() > 0


def test_mahalanobis_scorer_handles_all_invalid():
    cfg = RansacConfig()
    T_h, p1, p2, _ = _random_problem(np.random.default_rng(1), H=32, N=128)
    _inl, cnt, rmse = _score(jnp.asarray(T_h), jnp.asarray(p1),
                             jnp.asarray(p2), jnp.zeros((128,), bool), cfg)
    assert int(jnp.sum(cnt)) == 0
    assert (np.asarray(rmse) == 1e9).all()


def gicp_problem(N, seed=5):
    """Warm-started plane-to-plane problem with random SPD covariances."""
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    p1[:, 2] += 2.5
    T = np.asarray(se3.exp(jnp.asarray(
        rng.normal(scale=0.03, size=6).astype(np.float32))))
    p2 = (p1 @ T[:3, :3].T + T[:3, 3]
          + rng.normal(scale=0.004, size=(N, 3))).astype(np.float32)
    A = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C1 = A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    B = rng.normal(scale=0.02, size=(N, 3, 3)).astype(np.float32)
    C2 = B @ B.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    valid = rng.uniform(size=N) > 0.2
    T0 = np.asarray(se3.exp(jnp.asarray(
        rng.normal(scale=0.02, size=6).astype(np.float32)))) @ T
    return [jnp.asarray(x) for x in (T0, p1, p2, C1, C2, valid)], T


def gicp_xla(T0, p1, p2, C1, C2, valid, cfg):
    """The plain fori_loop path of solvers/icp.gicp_refine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(icp, "kernel_impl", lambda op, **kw: "xla")
        return icp.gicp_refine(p1, p2, valid, T0, None, cfg, C1=C1, C2=C2)


# 256 points; the live budget (1024, a power of two); the reference's
# native 1000-feature budget (padded to 1024 inside the wrapper)
@pytest.mark.parametrize("N,iters", [(256, 8), (1024, 10), (1000, 10)])
def test_gicp_loop_kernel_matches_xla_loop(N, iters):
    """The one-launch full-loop GICP kernel must match the XLA fori_loop
    (same per-round math: normal equations -> damped Cholesky -> SE(3)
    exp-compose)."""
    (T0, p1, p2, C1, C2, valid), T = gicp_problem(N)
    cfg = IcpConfig(max_iterations=iters, max_correspondence_dist=0.15)
    T_x, conv_x, _n = gicp_xla(T0, p1, p2, C1, C2, valid, cfg)
    assert bool(conv_x)
    T_k, _cost, cnt = gicp_refine_kernel(
        T0, p1, p2, C1, C2, valid, cfg.max_iterations,
        cfg.max_correspondence_dist, interpret=True)
    np.testing.assert_allclose(np.asarray(T_k), np.asarray(T_x),
                               rtol=1e-4, atol=1e-5)
    assert 0 < float(cnt) <= float(jnp.sum(valid))
    # and it actually recovered the ground-truth transform
    err = np.linalg.norm(np.asarray(T_k)[:3, 3] - T[:3, 3])
    assert err < 5e-3, err


def test_gicp_refine_routes_through_kernel(monkeypatch):
    """With the kernel selected, gicp_refine returns the kernel's pose
    through the shared convergence gate."""
    (T0, p1, p2, C1, C2, valid), _ = gicp_problem(256, seed=9)
    cfg = IcpConfig(max_iterations=6, max_correspondence_dist=0.15)
    calls = []

    def fake_kernel(*args, **kw):
        calls.append((args[6:8], kw))
        return gicp_refine_kernel(*args, interpret=True)

    monkeypatch.setattr(icp, "kernel_impl", lambda op, **kw: "triton")
    monkeypatch.setattr(icp, "gicp_refine_kernel", fake_kernel)
    T_k, conv, n = icp.gicp_refine(p1, p2, valid, T0, None, cfg,
                                   C1=C1, C2=C2)
    # compiled kernel: the live path never asks for the interpreter
    assert calls == [((6, 0.15), {})]
    T_x, _, _ = gicp_xla(T0, p1, p2, C1, C2, valid, cfg)
    assert bool(conv) and int(n) == int(jnp.sum(valid))
    np.testing.assert_allclose(np.asarray(T_k), np.asarray(T_x),
                               rtol=1e-4, atol=1e-5)


def test_gicp_refine_asks_for_its_point_count(monkeypatch):
    """The kernel choice sees the number of points, so the size bound in
    ops/backend.py applies."""
    (T0, p1, p2, C1, C2, valid), _ = gicp_problem(300, seed=2)
    asked = []

    def record(op, **kw):
        asked.append((op, kw))
        return "xla"

    monkeypatch.setattr(icp, "kernel_impl", record)
    icp.gicp_refine(p1, p2, valid, T0, None,
                    IcpConfig(max_iterations=2), C1=C1, C2=C2)
    assert asked == [("gicp", {"size": 300})]


@pytest.mark.parametrize("n_pad,warps", [(1024, 8), (2048, 8), (4096, 16)])
def test_gicp_kernel_warps_by_size(n_pad, warps):
    """More warps where 8 would spill the per-point planes."""
    from rgbdslam.ops.pallas_kernels import _gicp_warps

    assert _gicp_warps(n_pad) == warps


def test_gicp_kernel_pads_to_power_of_two():
    from rgbdslam.ops.pallas_kernels import _pack_gicp_inputs

    (T0, p1, p2, C1, C2, valid), _ = gicp_problem(1000)
    rt, planes = _pack_gicp_inputs(T0, p1, p2, C1, C2, valid)
    assert rt.shape == (16,) and planes.shape == (32, 1024)
    # padding points are invalid; unused planes are zero
    assert not np.asarray(planes[18, 1000:]).any()
    assert not np.asarray(planes[19:]).any()
    np.testing.assert_array_equal(np.asarray(planes[18, :1000]),
                                  np.asarray(valid, np.float32))
