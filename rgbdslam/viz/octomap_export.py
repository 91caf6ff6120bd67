"""Occupancy-map export: rebuild the octomap-equivalent grid from keyframes.

The reference's octomap is (re)built by the viewer thread from the per-KF
filtered clouds whenever the map's big-change epoch advances
(Drawer/MapDrawer.cpp:48-71 -> OctomapDrawer::insertCloud,
Drawer/OctomapDrawer.cpp:38-79) — i.e. always from the CURRENT (optimized)
keyframe poses. This module is that rebuild as a batch job: the driver keeps
each keyframe's (gray, depth) images, and at export time every keyframe's
cloud (System/Tracking.cpp:234-237 recipe) is ray-integrated into one dense
log-odds grid (mapping/occupancy.py) under the final optimized poses.

Everything device-side is jitted and shape-stable (one compile for all
keyframes: clouds have a fixed max_points budget, the grid a fixed extent).
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.config import KeyframeConfig
from rgbdslam.geometry.camera import Camera
from rgbdslam.geometry import se3
from rgbdslam.mapping.cloud import keyframe_cloud, transform_cloud
from rgbdslam.mapping.occupancy import (OccupancyGrid, insert_cloud,
                                        make_grid)


def build_occupancy_from_keyframes(
    cam: Camera,
    kf_images: Dict[int, Tuple[np.ndarray, np.ndarray]],  # k -> (gray, depth)
    poses_cw: np.ndarray,                                  # (>=K, 4, 4) FINAL
    kf_cfg: KeyframeConfig = KeyframeConfig(),
    resolution: float = 0.08,          # OctomapDrawer.cpp:17
    margin: float = 0.5,
    max_points: int = 4096,
) -> OccupancyGrid:
    """One occupancy grid from all keyframes under their optimized poses."""
    ks = sorted(kf_images)
    if not ks:
        raise ValueError("no keyframe images retained")
    Twc = se3.inverse_np(np.stack([poses_cw[k] for k in ks])).astype(
        np.float32)
    centers = Twc[:, :3, 3]
    lo = centers.min(axis=0) - (kf_cfg.cloud_z_max + margin)
    hi = centers.max(axis=0) + (kf_cfg.cloud_z_max + margin)
    grid = make_grid(lo, hi, resolution=resolution)
    for i, k in enumerate(ks):
        gray, depth = kf_images[k]
        c = keyframe_cloud(
            cam, jnp.asarray(gray), jnp.asarray(depth),
            stride=kf_cfg.cloud_stride,
            z_min=kf_cfg.cloud_z_min, z_max=kf_cfg.cloud_z_max,
            voxel=kf_cfg.voxel_size, sor_k=kf_cfg.sor_neighbors,
            sor_std=kf_cfg.sor_std_mul, max_points=max_points,
        )
        T = jnp.asarray(Twc[i])
        grid = insert_cloud(grid, transform_cloud(c, T), T[:3, 3])
    return grid


import functools


@functools.lru_cache(maxsize=8)
def _batch_insert_program(cam: Camera, kf_cfg: KeyframeConfig,
                          max_points: int):
    """ONE jitted program inserting a padded batch of keyframes into the
    grid via lax.scan (an all-invalid row is a no-op insert). The live
    exporter's worker thread shares the RPC channel with the tracking
    thread, so per-keyframe dispatches are the contention to avoid —
    batching cuts them ~8x."""

    @jax.jit
    def run(grid, grays, depths, Twc, kf_ok):
        def body(g, inp):
            gray, depth, T, ok = inp
            c = keyframe_cloud(
                cam, gray, depth,
                stride=kf_cfg.cloud_stride,
                z_min=kf_cfg.cloud_z_min, z_max=kf_cfg.cloud_z_max,
                voxel=kf_cfg.voxel_size, sor_k=kf_cfg.sor_neighbors,
                sor_std=kf_cfg.sor_std_mul, max_points=max_points,
            )
            c = c._replace(valid=c.valid & ok)
            g2 = insert_cloud(g, transform_cloud(c, T), T[:3, 3])
            return g2, 0
        grid, _ = jax.lax.scan(body, grid, (grays, depths, Twc, kf_ok))
        return grid

    return run


class IncrementalOccupancyBuilder:
    """Live occupancy maintenance with the reference's two-level semantics:
    per-keyframe cloud insertion dedup'd by KF id between big changes
    (OctomapDrawer::insertCloud, Drawer/OctomapDrawer.cpp:38-79 keeps
    mInsertedKFs), and a full reset + reinsert when the map's big-change
    epoch advances (MapDrawer.cpp:48-71 + Core/Map.cpp:134-144) or a new
    keyframe center leaves the grid bounds. Incremental ticks cost only the
    NEW keyframes' cloud programs; the O(all-KFs) rebuild happens once per
    loop closure."""

    def __init__(self, resolution: float = 0.08, margin: float = 0.5,
                 bound_slack: float = 1.0, max_points: int = 4096):
        self.resolution = resolution
        self.margin = margin
        self.bound_slack = bound_slack
        self.max_points = max_points
        self.grid = None
        self.ids = set()
        self.epoch = -1
        self._lo = self._hi = None

    def update(self, cam: Camera, kf_images, poses_cw: np.ndarray,
               epoch: int, kf_cfg: KeyframeConfig):
        """Insert new keyframes (or rebuild on epoch advance / bounds
        overflow). Returns (grid, changed: bool)."""
        ks = sorted(kf_images)
        if not ks:
            return self.grid, False
        Twc = se3.inverse_np(np.stack([poses_cw[k] for k in ks])).astype(
            np.float32)
        centers = Twc[:, :3, 3]
        reach = kf_cfg.cloud_z_max + self.margin
        lo_need = centers.min(axis=0) - reach
        hi_need = centers.max(axis=0) + reach
        rebuild = (self.grid is None or epoch > self.epoch
                   or np.any(lo_need < self._lo)
                   or np.any(hi_need > self._hi))
        if rebuild:
            self._lo = lo_need - self.bound_slack
            # quantize dims to 64-cell buckets: every distinct grid SHAPE
            # is a fresh XLA program (seconds of compile each), so
            # growing bounds must reuse shapes; the persistent cache then
            # serves repeated runs too
            span = (hi_need + self.bound_slack) - self._lo
            dims = np.ceil(span / self.resolution / 64.0) * 64.0
            self._hi = self._lo + dims * self.resolution
            self.grid = make_grid(self._lo, self._hi,
                                  resolution=self.resolution)
            self.ids = set()
            self.epoch = epoch
        new = [(i, k) for i, k in enumerate(ks) if k not in self.ids]
        if not new:
            return self.grid, rebuild
        prog = _batch_insert_program(cam, kf_cfg, self.max_points)
        B = 8
        for lo in range(0, len(new), B):
            chunk = new[lo:lo + B]
            pad = B - len(chunk)
            grays = jnp.stack(
                [jnp.asarray(kf_images[k][0]) for _, k in chunk]
                + [jnp.asarray(kf_images[chunk[0][1]][0])] * pad)
            depths = jnp.stack(
                [jnp.asarray(kf_images[k][1]) for _, k in chunk]
                + [jnp.asarray(kf_images[chunk[0][1]][1])] * pad)
            T_b = jnp.asarray(np.stack(
                [Twc[i] for i, _ in chunk]
                + [np.eye(4, dtype=np.float32)] * pad))
            ok = jnp.asarray(
                np.array([True] * len(chunk) + [False] * pad))
            self.grid = prog(self.grid, grays, depths, T_b, ok)
            self.ids.update(k for _, k in chunk)
        return self.grid, True


class KeyframeImageKeeper:
    """Driver-side retention of keyframe (gray, depth) images for the
    export-time occupancy rebuild (the reference's Frame keeps its images
    for the same purpose, Core/Frame.h:24-216). Bounded by `max_frames`
    (stride-skips beyond it to stay within memory on long runs)."""

    def __init__(self, max_frames: int = 512, materialize: bool = True):
        # materialize=False keeps array REFERENCES (device arrays stay on
        # device) instead of host copies — the live exporter's mode: a host
        # copy of a device-resident frame is a blocking fetch RPC on the
        # tracking hot path
        self.max_frames = max_frames
        self.materialize = materialize
        self.images: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._skip = 1

    def offer(self, k: int, gray, depth) -> None:
        if k % self._skip != 0:
            return
        if len(self.images) >= self.max_frames:
            # thin: keep every other retained keyframe, double the stride
            self.images = {kk: v for kk, v in self.images.items()
                           if kk % (self._skip * 2) == 0}
            self._skip *= 2
            if k % self._skip != 0:
                return
        if self.materialize:
            self.images[k] = (np.asarray(gray), np.asarray(depth))
        else:
            self.images[k] = (gray, depth)
