"""Descriptor matching with the reference Matcher's gates, as one array program.

Reference semantics (Features/Matcher.cpp:106-139): brute-force kNN(k=2)
Hamming matching of ref descriptors (queries) against cur descriptors (train),
Lowe ratio test (VO passes 0.9, System/Tracking.cpp:125), train-index
deduplication, and validity gates (both endpoints must have valid depth).

Array-program re-design: the full N x M distance matrix is computed at once
(ops/hamming.py), the ratio test is a vectorized compare, and train-dedup becomes *mutual-nearest* selection — the
reference's first-query-wins scan is order-dependent; mutual-best is the
deterministic, order-free equivalent (keeps the minimum-distance match per
train index, a strict superset of the reference's rejection).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rgbdslam.frontend.frame import FrameFeatures
from rgbdslam.ops import hamming
from rgbdslam.ops.hamming import BIG_DIST
from rgbdslam.utils import pytree


@pytree.dataclass
class MatchResult:
    """Matches from frame1 (ref/query) into frame2 (cur/train), N1 slots."""

    idx2: jnp.ndarray    # (N1,) i32 matched index in frame2
    dist: jnp.ndarray    # (N1,) i32 Hamming distance
    valid: jnp.ndarray   # (N1,) bool match survives all gates

    @property
    def num_matches(self) -> jnp.ndarray:
        return jnp.sum(self.valid)


def match_descriptors(
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid2: jnp.ndarray,
    ratio: float = 0.9,
) -> MatchResult:
    """Core 2-NN ratio + mutual-nearest matching on packed descriptors.

    Distances come from ops/hamming.py in its default form. (i -> j) is kept
    iff j is i's nearest train, i is j's nearest query (mutual-nearest
    dedup), and the Lowe ratio passes.

    Float descriptors (SIFT/SURF-class, ops/descriptors.py) dispatch to the
    L2 path — the reference picks NORM_HAMMING vs NORM_L2 from the descriptor
    dtype the same way (Features/Matcher.cpp:16, Extractor::mNorm).
    """
    if jnp.issubdtype(desc1.dtype, jnp.floating):
        return _match_descriptors_l2(desc1, valid1, desc2, valid2, ratio)
    d = hamming.hamming_distance_matrix(desc1, desc2, valid1, valid2)
    best_idx, best_dist, second_dist = hamming.knn2(d)
    col_best = jnp.argmin(d, axis=0).astype(jnp.int32)  # (N2,)

    ratio_ok = best_dist.astype(jnp.float32) < ratio * second_dist.astype(jnp.float32)
    rows = jnp.arange(desc1.shape[0], dtype=jnp.int32)
    mutual = col_best[best_idx] == rows
    valid = ratio_ok & mutual & valid1 & (best_dist < BIG_DIST)
    return MatchResult(idx2=best_idx, dist=best_dist, valid=valid)


def _match_descriptors_l2(
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid2: jnp.ndarray,
    ratio: float = 0.9,
) -> MatchResult:
    """L2 2-NN + ratio + mutual-nearest on float descriptors (one matmul:
    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b)."""
    big = jnp.float32(1e12)
    n1 = jnp.sum(desc1 * desc1, axis=-1)                   # (N1,)
    n2 = jnp.sum(desc2 * desc2, axis=-1)                   # (N2,)
    cross = desc1 @ desc2.T                                 # (N1, N2)
    d2 = jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * cross, 0.0)
    d2 = jnp.where(valid1[:, None] & valid2[None, :], d2, big)

    best_idx = jnp.argmin(d2, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d2, best_idx[:, None], axis=1)[:, 0]
    cols = jnp.arange(d2.shape[1], dtype=jnp.int32)
    second = jnp.min(
        jnp.where(cols[None, :] == best_idx[:, None], big, d2), axis=1
    )
    # ratio test on distances (not squared): d < r * d2nd
    ratio_ok = jnp.sqrt(best) < ratio * jnp.sqrt(second)
    col_best = jnp.argmin(d2, axis=0).astype(jnp.int32)
    rows = jnp.arange(desc1.shape[0], dtype=jnp.int32)
    mutual = col_best[best_idx] == rows
    valid = ratio_ok & mutual & valid1 & (best < big)
    return MatchResult(idx2=best_idx, dist=jnp.sqrt(best), valid=valid)


@jax.jit
def match_frames(
    f1: FrameFeatures,
    f2: FrameFeatures,
    ratio: float = 0.9,
) -> MatchResult:
    """Matcher::match semantics over FrameFeatures: both endpoints must be
    valid observations (detected + valid depth, Features/Matcher.cpp:130)."""
    m = match_descriptors(f1.desc, f1.obs_valid, f2.desc, f2.obs_valid, ratio)
    valid = m.valid & f2.obs_valid[m.idx2]
    return m.replace(valid=valid)


@functools.partial(jax.jit, static_argnums=(3,))
def projection_match(
    f1: FrameFeatures,
    f2: FrameFeatures,
    T_cw2_mul_wc1: jnp.ndarray,
    cam=None,
    radius: float = 15.0,
    th_high: int = 100,
) -> MatchResult:
    """Projection-guided matching (Matcher::projectionMatch,
    Features/Matcher.cpp:35-104): project frame-1 points into frame 2, search
    frame-2 keypoints within a pixel radius, pick the minimum-descriptor-
    distance candidate <= TH_HIGH.

    The reference walks a 64x48 spatial hash grid per keypoint
    (Frame::getFeaturesInArea); here the window query is a dense masked
    (N1, N2) distance computation — no grid needed at these sizes.

    T_cw2_mul_wc1: (4, 4) transform taking frame-1 camera coords to frame-2
    camera coords (T21). cam: static Camera.
    """
    q = se3_transform(T_cw2_mul_wc1, f1.xyz)          # (N1, 3) in cam-2
    z = jnp.maximum(q[:, 2], 1e-6)
    u = cam.fx * q[:, 0] / z + cam.cx
    v = cam.fy * q[:, 1] / z + cam.cy
    proj_ok = (
        f1.obs_valid & (q[:, 2] > 0)
        & (u >= 0) & (u <= cam.width - 1)
        & (v >= 0) & (v <= cam.height - 1)
    )
    duv = jnp.stack([u, v], axis=-1)[:, None, :] - f2.uv_undist[None, :, :]
    in_window = jnp.sum(duv * duv, axis=-1) <= radius * radius  # (N1, N2)

    d = hamming.hamming_distance_matrix(f1.desc, f2.desc, proj_ok, f2.obs_valid)
    d = jnp.where(in_window, d, BIG_DIST)
    best_idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    # train dedup by mutual-nearest (reference: first-come wins, order-dep.)
    col_best = jnp.argmin(d, axis=0).astype(jnp.int32)
    rows = jnp.arange(f1.desc.shape[0], dtype=jnp.int32)
    mutual = col_best[best_idx] == rows
    valid = proj_ok & mutual & (best_dist <= th_high)
    return MatchResult(idx2=best_idx, dist=best_dist, valid=valid)


def se3_transform(T: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def correspondence_weights(p1: jnp.ndarray, p2: jnp.ndarray,
                           valid: jnp.ndarray) -> jnp.ndarray:
    """Fit weights 1/(z1*z2) for matched 3-D pairs, zero where invalid
    (Solver/SolverSE3.cpp:174) — the single source of the weighting
    convention used by VO, proximity verification, and loop verification."""
    z1 = jnp.maximum(p1[:, 2], 1e-6)
    z2 = jnp.maximum(p2[:, 2], 1e-6)
    return jnp.where(valid, 1.0 / (z1 * z2), 0.0)


@jax.jit
def gather_matched_points(f1: FrameFeatures, f2: FrameFeatures, m: MatchResult):
    """Matched 3D-3D correspondence arrays (camera frames), masked.

    Returns (p1 [N,3], p2 [N,3], w [N] weights 1/(z1*z2), valid [N]) — the
    inputs of the RansacSE3 equivalent.
    """
    p1 = f1.xyz
    p2 = f2.xyz[m.idx2]
    return p1, p2, correspondence_weights(p1, p2, m.valid), m.valid
