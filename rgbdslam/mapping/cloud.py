"""Per-keyframe point-cloud pipeline as fixed-shape array programs.

Array-program Frame cloud stack (Core/Frame.cpp:475-608 + the keyframe recipe in
System/Tracking.cpp:234-237): createCloud(stride) -> pass-through z filter ->
voxel-grid downsample -> statistical outlier removal -> world transform.

Re-design: PCL's dynamically-sized clouds + octree voxel filter become
fixed-budget point arrays with validity masks; the voxel filter is a
sort-by-voxel-key + segment-mean (no trees); SOR's k-NN mean distances are a
masked dense distance matrix (cloud budgets are a few thousand points — the
N^2 matrix is trivial elementwise work).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera, depth_to_points


class Cloud(NamedTuple):
    xyz: jnp.ndarray       # (M, 3)
    intensity: jnp.ndarray  # (M,) gray value (the reference keeps RGB,
                            #   Core/Frame.cpp:497-500)
    valid: jnp.ndarray     # (M,) bool

    @property
    def count(self):
        return jnp.sum(self.valid)


@functools.partial(jax.jit, static_argnums=(0, 3))
def create_cloud(
    cam: Camera,
    gray: jnp.ndarray,
    depth: jnp.ndarray,
    stride: int = 6,
    z_min: float = 0.5,
    z_max: float = 4.0,
) -> Cloud:
    """Strided depth-image backprojection + pass-through z filter
    (Frame::createCloud(res) + passThroughFilter, Core/Frame.cpp:475-549)."""
    d = depth[::stride, ::stride]
    g = gray[::stride, ::stride]
    h, w = d.shape
    vv, uu = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) * stride,
        jnp.arange(w, dtype=jnp.float32) * stride,
        indexing="ij",
    )
    x = (uu - cam.cx) / cam.fx * d
    y = (vv - cam.cy) / cam.fy * d
    pts = jnp.stack([x, y, d], axis=-1)
    valid = (d > z_min) & (d < z_max) & jnp.isfinite(d)
    return Cloud(
        xyz=pts.reshape(-1, 3),
        intensity=g.reshape(-1),
        valid=valid.reshape(-1),
    )


@functools.partial(jax.jit, static_argnums=(1,))
def voxel_downsample(cloud: Cloud, max_points: int, voxel: float = 0.04) -> Cloud:
    """Voxel-grid centroid downsample (Frame::downsampleCloud,
    Core/Frame.cpp:517-525) via sort + segment-mean, fixed output budget."""
    pts = cloud.xyz
    n = pts.shape[0]
    key = jnp.where(
        cloud.valid,
        _voxel_key(pts, voxel),
        jnp.iinfo(jnp.int32).max,
    )
    order = jnp.argsort(key)
    key_s = key[order]
    pts_s = pts[order]
    int_s = cloud.intensity[order]
    valid_s = cloud.valid[order]

    starts = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]]
    ) & valid_s
    seg = jnp.cumsum(starts) - 1  # segment id per point
    seg = jnp.where(valid_s, seg, max_points - 1)
    seg = jnp.minimum(seg, max_points - 1)

    w = valid_s.astype(pts.dtype)
    sums = jax.ops.segment_sum(pts_s * w[:, None], seg, num_segments=max_points)
    ints = jax.ops.segment_sum(int_s * w, seg, num_segments=max_points)
    counts = jax.ops.segment_sum(w, seg, num_segments=max_points)
    centroid = sums / jnp.maximum(counts[:, None], 1.0)
    inten = ints / jnp.maximum(counts, 1.0)
    n_voxels = jnp.sum(starts)
    out_valid = (jnp.arange(max_points) < n_voxels) & (counts > 0)
    return Cloud(xyz=centroid, intensity=inten, valid=out_valid)


def _voxel_key(pts: jnp.ndarray, voxel: float) -> jnp.ndarray:
    q = jnp.floor(pts / voxel).astype(jnp.int32) + 2**15
    return (q[..., 0] << 20) ^ (q[..., 1] << 10) ^ q[..., 2]


@functools.partial(jax.jit, static_argnums=(1,))
def statistical_outlier_removal(
    cloud: Cloud, k: int = 50, std_mul: float = 1.0
) -> Cloud:
    """PCL StatisticalOutlierRemoval semantics (Frame::statisticalFilterCloud,
    Core/Frame.cpp:527-536): mean distance to k NN; drop points whose mean
    exceeds global mean + std_mul * std."""
    pts = cloud.xyz
    d2 = jnp.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    big = 1e12
    mask = cloud.valid[:, None] & cloud.valid[None, :]
    d2 = jnp.where(mask, d2, big)
    d2 = jnp.fill_diagonal(d2, big, inplace=False)
    neg_topk, _ = jax.lax.top_k(-d2, k)
    knn_d = jnp.sqrt(jnp.maximum(-neg_topk, 0.0))
    knn_valid = (-neg_topk) < big * 0.5
    mean_d = jnp.sum(knn_d * knn_valid, axis=-1) / jnp.maximum(
        jnp.sum(knn_valid, axis=-1), 1
    )
    wm = cloud.valid.astype(pts.dtype)
    mu = jnp.sum(mean_d * wm) / jnp.maximum(jnp.sum(wm), 1.0)
    var = jnp.sum((mean_d - mu) ** 2 * wm) / jnp.maximum(jnp.sum(wm), 1.0)
    thresh = mu + std_mul * jnp.sqrt(var)
    keep = cloud.valid & (mean_d <= thresh)
    return Cloud(xyz=cloud.xyz, intensity=cloud.intensity, valid=keep)


@jax.jit
def transform_cloud(cloud: Cloud, Twc: jnp.ndarray) -> Cloud:
    """Camera-frame -> world-frame (Frame::cloudToWorld,
    Core/Frame.cpp:551-608)."""
    return Cloud(
        xyz=se3.transform_points(Twc, cloud.xyz),
        intensity=cloud.intensity,
        valid=cloud.valid,
    )


def keyframe_cloud(
    cam: Camera,
    gray: jnp.ndarray,
    depth: jnp.ndarray,
    stride: int = 6,
    z_min: float = 0.5,
    z_max: float = 4.0,
    voxel: float = 0.04,
    sor_k: int = 50,
    sor_std: float = 1.0,
    max_points: int = 4096,
) -> Cloud:
    """The full keyframe cloud recipe (System/Tracking.cpp:234-237)."""
    c = create_cloud(cam, gray, depth, stride, z_min, z_max)
    c = voxel_downsample(c, max_points, voxel)
    c = statistical_outlier_removal(c, sor_k, sor_std)
    return c
