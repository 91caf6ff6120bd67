"""Occupancy voxel mapping: the octomap replacement, as a dense log-odds grid.

Array-program Drawer/OctomapDrawer.{h,cpp}: the reference maintains an
octomap::ColorOcTree with per-KF ray insertion and hit/miss probability
updates (OctomapDrawer.cpp:15-79: res 0.08 m, clamping 0.001/0.999, hit 0.9,
miss 0.4). An octree is the wrong structure for an accelerator; for bounded scenes a
dense 3D log-odds grid is a few MB and every update is a fused scatter:

- rays are marched in fixed steps from the camera center to each cloud point
  (free-space updates), endpoint voxels get hit updates — one big
  [P x S] -> flat-index scatter-add per keyframe,
- clamping via jnp.clip (OcTree clamping thresholds),
- colors (intensity here) averaged per voxel like ColorOcTree
  (OctomapDrawer.cpp:60-68).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.mapping.cloud import Cloud


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


class OccupancyGrid(NamedTuple):
    log_odds: jnp.ndarray    # (Gx, Gy, Gz) f32
    color_sum: jnp.ndarray   # (Gx, Gy, Gz) f32 intensity accumulator
    color_cnt: jnp.ndarray   # (Gx, Gy, Gz) f32
    origin: jnp.ndarray      # (3,) world coords of voxel (0,0,0) corner
    resolution: float

    @property
    def occupancy(self) -> jnp.ndarray:
        return jax.nn.sigmoid(self.log_odds)


def make_grid(
    bounds_min, bounds_max, resolution: float = 0.08
) -> OccupancyGrid:
    bounds_min = np.asarray(bounds_min, np.float32)
    bounds_max = np.asarray(bounds_max, np.float32)
    dims = tuple(
        int(math.ceil((hi - lo) / resolution))
        for lo, hi in zip(bounds_min, bounds_max)
    )
    return OccupancyGrid(
        log_odds=jnp.zeros(dims, jnp.float32),
        color_sum=jnp.zeros(dims, jnp.float32),
        color_cnt=jnp.zeros(dims, jnp.float32),
        origin=jnp.asarray(bounds_min),
        resolution=resolution,
    )


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def insert_cloud(
    grid: OccupancyGrid,
    world_cloud: Cloud,
    sensor_origin: jnp.ndarray,
    n_steps: int = 64,
    hit_p: float = 0.9,          # OctomapDrawer.cpp:23
    miss_p: float = 0.4,         # OctomapDrawer.cpp:24
    clamp_min_p: float = 0.001,  # OctomapDrawer.cpp:21
    clamp_max_p: float = 0.999,  # OctomapDrawer.cpp:22
) -> OccupancyGrid:
    """Ray-integrate one world-frame keyframe cloud
    (OctomapDrawer::insertCloud, Drawer/OctomapDrawer.cpp:38-79)."""
    res = grid.resolution
    dims = grid.log_odds.shape
    pts = world_cloud.xyz                     # (P, 3)
    valid = world_cloud.valid

    # free-space samples strictly inside the ray (exclude the endpoint voxel)
    ts = (jnp.arange(n_steps, dtype=jnp.float32) + 0.5) / n_steps  # (S,)
    ray = pts[None, :, :] * ts[:, None, None] + sensor_origin[None, None, :] * (
        1.0 - ts[:, None, None]
    )  # (S, P, 3)

    def to_idx(p):
        q = jnp.floor((p - grid.origin) / res).astype(jnp.int32)
        inb = (
            (q[..., 0] >= 0) & (q[..., 0] < dims[0])
            & (q[..., 1] >= 0) & (q[..., 1] < dims[1])
            & (q[..., 2] >= 0) & (q[..., 2] < dims[2])
        )
        qc = jnp.clip(q, 0, jnp.asarray(dims, jnp.int32) - 1)
        flat = (qc[..., 0] * dims[1] + qc[..., 1]) * dims[2] + qc[..., 2]
        return flat, inb

    end_flat, end_inb = to_idx(pts)
    ray_flat, ray_inb = to_idx(ray)
    # a free-space sample falling in the endpoint voxel must not erase the hit
    ray_is_end = ray_flat == end_flat[None, :]

    lo = grid.log_odds.reshape(-1)
    l_hit = _logit(hit_p)
    l_miss = _logit(miss_p)

    # octomap's insertPointCloud set semantics (octomap updateNode over
    # KeySet free_cells / occupied_cells; reference usage
    # Drawer/OctomapDrawer.cpp:38-79): per SCAN each traversed voxel gets
    # exactly ONE miss update and each endpoint voxel ONE hit update, with
    # occupied winning over free. Scatter-MAX visited/occupied flags instead
    # of scatter-ADD, then apply each update once — exact octomap semantics
    # up to ray-sampling coverage (n_steps bounds voxels visited per ray).
    miss_w = (ray_inb & valid[None, :] & ~ray_is_end).astype(jnp.float32)
    visited = jnp.zeros_like(lo).at[ray_flat.reshape(-1)].max(
        miss_w.reshape(-1))
    hit_w = (end_inb & valid).astype(jnp.float32)
    occupied = jnp.zeros_like(lo).at[end_flat].max(hit_w)

    lo = lo + l_miss * visited * (1.0 - occupied) + l_hit * occupied
    lo = jnp.clip(lo, _logit(clamp_min_p), _logit(clamp_max_p))

    cs = grid.color_sum.reshape(-1).at[end_flat].add(hit_w * world_cloud.intensity)
    cc = grid.color_cnt.reshape(-1).at[end_flat].add(hit_w)

    return OccupancyGrid(
        log_odds=lo.reshape(dims),
        color_sum=cs.reshape(dims),
        color_cnt=cc.reshape(dims),
        origin=grid.origin,
        resolution=grid.resolution,
    )


def save_grid(path: str, grid: OccupancyGrid, extra: dict | None = None,
              sparse_cap: int | None = None) -> None:
    """Persist the occupancy map (OctomapDrawer::save analog,
    Drawer/OctomapDrawer.cpp:27-36 — which the reference never calls).
    `extra` adds metadata fields (e.g. the big-change epoch the live
    exporter stamps, Core/Map.cpp:134-144).

    sparse_cap: write only touched voxels (fixed-cap device-side
    jnp.nonzero + gather), cutting the device->host transfer from the full
    dense grid (~165 MB at 0.08 m over a room) to the touched set — the
    live exporter's mode, where a dense fetch would hold the
    device-to-host channel for a long transfer. Falls back to dense when the touched
    count exceeds the cap. load_grid reads both layouts."""
    if sparse_cap is not None:
        import jax.numpy as jnp

        lo = grid.log_odds.reshape(-1)
        n_touched = int(jnp.sum(lo != 0.0))
        if n_touched <= sparse_cap:
            (idx,) = jnp.nonzero(lo != 0.0, size=sparse_cap, fill_value=0)
            valid = jnp.arange(sparse_cap) < n_touched
            np.savez_compressed(
                path,
                sparse_dims=np.asarray(grid.log_odds.shape),
                sparse_idx=np.asarray(jnp.where(valid, idx, 0),
                                      dtype=np.int64)[:n_touched],
                log_odds=np.asarray(lo[idx])[:n_touched],
                color_sum=np.asarray(
                    grid.color_sum.reshape(-1)[idx])[:n_touched],
                color_cnt=np.asarray(
                    grid.color_cnt.reshape(-1)[idx])[:n_touched],
                origin=np.asarray(grid.origin),
                resolution=np.asarray(grid.resolution),
                **(extra or {}),
            )
            return
    np.savez_compressed(
        path,
        log_odds=np.asarray(grid.log_odds),
        color_sum=np.asarray(grid.color_sum),
        color_cnt=np.asarray(grid.color_cnt),
        origin=np.asarray(grid.origin),
        resolution=np.asarray(grid.resolution),
        **(extra or {}),
    )


def load_grid(path: str) -> OccupancyGrid:
    import jax.numpy as jnp

    d = np.load(path)
    if "sparse_dims" in d:
        dims = tuple(int(x) for x in d["sparse_dims"])
        idx = d["sparse_idx"]

        def densify(vals, dtype):
            full = np.zeros(int(np.prod(dims)), dtype)
            full[idx] = vals
            return jnp.asarray(full.reshape(dims))

        return OccupancyGrid(
            log_odds=densify(d["log_odds"], np.float32),
            color_sum=densify(d["color_sum"], np.float32),
            color_cnt=densify(d["color_cnt"], np.float32),
            origin=jnp.asarray(d["origin"]),
            resolution=float(d["resolution"]),
        )
    return OccupancyGrid(
        log_odds=jnp.asarray(d["log_odds"]),
        color_sum=jnp.asarray(d["color_sum"]),
        color_cnt=jnp.asarray(d["color_cnt"]),
        origin=jnp.asarray(d["origin"]),
        resolution=float(d["resolution"]),
    )


def occupied_voxels(grid: OccupancyGrid, threshold: float = 0.9):
    """World-space centers + mean intensity of voxels with occupancy >=
    threshold (the render set, Drawer/OctomapDrawer.cpp:133-216).
    Host-side (dynamic count)."""
    occ = np.asarray(grid.occupancy)
    mask = occ >= threshold
    idx = np.argwhere(mask)
    centers = (idx + 0.5) * grid.resolution + np.asarray(grid.origin)
    cnt = np.asarray(grid.color_cnt)[mask]
    col = np.asarray(grid.color_sum)[mask] / np.maximum(cnt, 1.0)
    return centers.astype(np.float32), col.astype(np.float32)
