"""Kernel parity on the card, at the widths the system runs.

The hand-written GICP kernel runs compiled for the GPU (no interpreter) and
is compared with its plain reference on the same device; the re-chosen XLA
forms (fused detector, Hamming, Mahalanobis scorer) are compared with their
references or with float64 NumPy. All arithmetic is float32 with
``jax_default_matmul_precision="float32"`` in force (set in
rgbdslam/__init__.py), so no product runs in TF32.

These tests skip without a GPU; ``python chip_smoke.py`` runs them with
``-s`` so the printed maxima land in its log.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.config import IcpConfig, RansacConfig
from rgbdslam.ops import hamming
from rgbdslam.ops.fast import masked_score_map, masked_score_map_reference
from rgbdslam.ops.pallas_kernels import gicp_refine_kernel
from rgbdslam.solvers.ransac_se3 import _score
from test_pallas_detect import _random_image, assert_detect_parity
from test_pallas_ransac import (_random_problem, gicp_problem, gicp_xla,
                                mahalanobis_scores_f64)

pytestmark = pytest.mark.gpu


# 640x480 and each level of its 4-level pyramid
@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (120, 160),
                                   (60, 80)])
def test_detect_on_gpu(gpu, shape):
    """Fused detector vs the composition: identical keep masks; scores within
    rtol 1e-5 / atol 1e-3 on integer-valued images (box sums of integers are
    exact in f32 in any order; the tolerance covers the final sqrt/scale
    rounding)."""
    with jax.default_device(gpu):
        img = _random_image(shape, seed=sum(shape))
        b, rb = masked_score_map(img, 20.0)
        a, ra = masked_score_map_reference(img, 20.0)
        assert_detect_parity(a, ra, b, rb)
        a, b = np.asarray(a), np.asarray(b)
        keep = np.isfinite(a)
        print(f"parity detect {shape[1]}x{shape[0]}: keep masks equal "
              f"({keep.sum()} kept), max |raw diff| "
              f"{np.abs(np.asarray(ra) - np.asarray(rb)).max():.3g}, "
              f"max |score diff| {np.abs(a[keep] - b[keep]).max():.3g}")


# the live budget, the reference's 1000, and up to the 4096-feature ceiling
@pytest.mark.parametrize("N", [1024, 1000, 2048, 4096])
def test_gicp_kernel_on_gpu(gpu, N):
    """T within rtol 1e-4 / atol 1e-5 of the XLA loop after 10 iterations:
    both take the same steps, but sum the 27 normal-equation terms in a
    different order and solve by Cholesky instead of LU."""
    cfg = IcpConfig(max_iterations=10, max_correspondence_dist=0.15)
    with jax.default_device(gpu):
        (T0, p1, p2, C1, C2, valid), T = gicp_problem(N)
        T_x, conv, _ = gicp_xla(T0, p1, p2, C1, C2, valid, cfg)
        T_k, _cost, _cnt = gicp_refine_kernel(
            T0, p1, p2, C1, C2, valid, cfg.max_iterations,
            cfg.max_correspondence_dist)
        assert bool(conv)
        np.testing.assert_allclose(np.asarray(T_k), np.asarray(T_x),
                                   rtol=1e-4, atol=1e-5)
        print(f"parity gicp N={N}: max |T diff| "
              f"{np.abs(np.asarray(T_k) - np.asarray(T_x)).max():.3g}")


def test_hamming_forms_on_gpu(gpu):
    """popcount and the int8 matmul form are bit-exact at 1024x1024."""
    rng = np.random.default_rng(7)
    with jax.default_device(gpu):
        d1 = jnp.asarray(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32))
        d2 = jnp.asarray(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32))
        v1 = jnp.asarray(rng.random(1024) > 0.1)
        v2 = jnp.asarray(rng.random(1024) > 0.1)
        a = hamming.hamming_distance_matrix(d1, d2, v1, v2, impl="popcount")
        b = hamming.hamming_distance_matrix(d1, d2, v1, v2, impl="mxu")
        n_diff = int(jnp.sum(a != b))
    assert n_diff == 0
    print(f"parity hamming 1024x1024: {n_diff} differing distances")


def test_mahalanobis_scorer_on_gpu(gpu):
    """Inlier counts at H=256, N=1024 equal float64 NumPy, except pairs
    within 1e-5 (relative) of the gate."""
    cfg = RansacConfig()
    T_h, p1, p2, valid = _random_problem(np.random.default_rng(3), 256, 1024)
    with jax.default_device(gpu):
        _inl, cnt, _ = _score(jnp.asarray(T_h), jnp.asarray(p1),
                              jnp.asarray(p2), jnp.asarray(valid), cfg)
    m2, cnt_ref = mahalanobis_scores_f64(T_h, p1, p2, valid, cfg)
    th = cfg.max_mahalanobis ** 2
    near = ((np.abs(m2 - th) <= 1e-5 * th) & valid[None]).sum(axis=1)
    diff = np.abs(np.asarray(cnt) - cnt_ref)
    assert (diff <= near).all()
    print(f"parity mahalanobis H=256 N=1024: max |count diff| {diff.max()} "
          f"(pairs within 1e-5 of the gate: {near.max()})")
