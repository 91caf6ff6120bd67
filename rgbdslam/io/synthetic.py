"""Procedural synthetic RGB-D sequence renderer with ground-truth trajectory.

The reference has only rudimentary synthetic hooks (random keypoints,
Core/RGBDcamera.cpp:163-192). Since this framework must be testable and
benchmarkable without dataset downloads, we render full RGB-D frames of a
textured box room by ray casting — a jit-compiled XLA program, so frames can
be generated directly on the device for benchmarking.

The texture is multi-frequency blocky value noise: piecewise-constant cells
produce strong gradients/corners everywhere, which is exactly what a
FAST/Shi-Tomasi frontend needs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.geometry.camera import Camera, SYNTHETIC

ROOM_HALF = jnp.array([3.0, 2.0, 3.0], dtype=jnp.float32)  # box half-extents (x, y, z)


def _hash3(ix: jnp.ndarray, iy: jnp.ndarray, iz: jnp.ndarray, seed: int) -> jnp.ndarray:
    """Integer lattice hash -> [0, 1). Deterministic, vectorized."""
    h = (
        ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
        + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
        + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F)
        + jnp.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    )
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 16)
    return h.astype(jnp.float32) * (1.0 / 4294967296.0)


def _blocky_noise(p: jnp.ndarray, freq: float, seed: int) -> jnp.ndarray:
    """Piecewise-constant 3D value noise at the given lattice frequency."""
    q = jnp.floor(p * freq)
    return _hash3(
        q[..., 0].astype(jnp.int32),
        q[..., 1].astype(jnp.int32),
        q[..., 2].astype(jnp.int32),
        seed,
    )


def texture(p: jnp.ndarray) -> jnp.ndarray:
    """World-space texture in [0, 1]: multi-scale blocky noise."""
    return (
        0.45 * _blocky_noise(p, 2.0, 1)
        + 0.30 * _blocky_noise(p, 5.0, 2)
        + 0.18 * _blocky_noise(p, 11.0, 3)
        + 0.07 * _blocky_noise(p, 23.0, 4)
    )


# --- multi-room world ---------------------------------------------------
# The single box room is an easy proxy (everything visible from everywhere,
# no occlusion, no genuinely new viewpoints); the multi-room world is a
# 12 x 4 x 6 m shell split by a doorway wall, with solid crates/pillars in
# each room — occlusion boundaries, depth discontinuities, and loop closures
# that must survive visiting a genuinely different place in between.
MULTIROOM_HALF = jnp.array([6.0, 2.0, 3.0], dtype=jnp.float32)
MULTIROOM_BOXES = np.array(
    [
        # dividing wall at x ~ 0, full height, doorway gap |z| < 0.7
        [[-0.1, -2.0, -3.0], [0.1, 2.0, -0.7]],
        [[-0.1, -2.0, 0.7], [0.1, 2.0, 3.0]],
        # room A (x < 0): corner crates + a pillar
        [[-5.6, -2.0, 1.9], [-4.7, -0.4, 2.7]],
        [[-5.4, -2.0, -2.7], [-4.6, -0.9, -2.0]],
        [[-2.3, -2.0, -2.8], [-1.7, 0.6, -2.2]],
        # room B (x > 0): crates + a pillar
        [[4.6, -2.0, 1.8], [5.4, -0.3, 2.6]],
        [[4.8, -2.0, -2.7], [5.6, -1.0, -1.9]],
        [[1.7, -2.0, 2.2], [2.3, 0.5, 2.8]],
    ],
    dtype=np.float32,
)


@functools.partial(jax.jit, static_argnums=0)
def render_frame(cam: Camera, Twc: jnp.ndarray,
                 room_half: jnp.ndarray | None = None,
                 boxes: jnp.ndarray | None = None,
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ray-cast one RGB-D frame of the box room (optionally with solid
    interior boxes — the multi-room world).

    Args:
      cam: static camera intrinsics. A camera WITH distortion coefficients
        is rendered through its radial-tangential model (each distorted
        pixel's ray goes through the undistorted normalized coords —
        physically what a real lens does), so fr1/fr2-class undistortion
        chains (Core/Frame.cpp:251-281) are exercisable end-to-end.
      Twc: camera-to-world pose (4, 4).
      room_half: (3,) shell half-extents (default ROOM_HALF).
      boxes: optional (Nb, 2, 3) solid AABBs [min, max] inside the shell.

    Returns:
      gray [H, W] float32 in [0, 255], depth [H, W] float32 meters (camera z).
    """
    h, w = cam.height, cam.width
    vv, uu = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    # camera-frame ray directions with unit z so that ray parameter == z-depth
    xn = jnp.stack(
        [(uu - cam.cx) / cam.fx, (vv - cam.cy) / cam.fy], axis=-1
    )
    if cam.has_distortion:
        from rgbdslam.geometry.camera import undistort_normalized

        xn = undistort_normalized(cam, xn)
    d_cam = jnp.concatenate([xn, jnp.ones_like(uu)[..., None]], axis=-1)
    R = Twc[:3, :3]
    o = Twc[:3, 3]
    d_world = d_cam @ R.T  # (H, W, 3)

    half = ROOM_HALF if room_half is None else room_half

    # Intersect with the 6 planes of the box from inside: for each axis and
    # sign, t = (bound - o)/d. The closest positive t whose hit stays inside
    # the box is the visible wall.
    t_best = jnp.full((h, w), jnp.inf, dtype=jnp.float32)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            bound = sign * half[axis]
            denom = d_world[..., axis]
            t = (bound - o[axis]) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
            hit = o + t[..., None] * d_world
            # inside the face (other two axes within bounds)
            ok = t > 1e-3
            for other in range(3):
                if other != axis:
                    ok = ok & (jnp.abs(hit[..., other]) <= half[other] + 1e-4)
            t_best = jnp.where(ok & (t < t_best), t, t_best)

    if boxes is not None:
        # solid AABBs, slab method: entry distance t_near where the ray
        # first crosses all three slabs (camera is outside every solid)
        inv_d = 1.0 / jnp.where(jnp.abs(d_world) < 1e-9, 1e-9, d_world)
        bmin = boxes[:, 0]                       # (Nb, 3)
        bmax = boxes[:, 1]
        t0 = (bmin[None, None] - o) * inv_d[..., None, :]   # (H, W, Nb, 3)
        t1 = (bmax[None, None] - o) * inv_d[..., None, :]
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)       # (H, W, Nb)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit = (t_near < t_far) & (t_near > 1e-3)
        t_box = jnp.min(jnp.where(hit, t_near, jnp.inf), axis=-1)  # (H, W)
        t_best = jnp.minimum(t_best, t_box)

    depth = jnp.where(jnp.isfinite(t_best), t_best, 0.0)
    hit_pts = o + t_best[..., None] * d_world
    shade = texture(hit_pts)
    # slight distance attenuation for realism
    gray = jnp.clip(30.0 + 210.0 * shade * (1.0 / (1.0 + 0.05 * depth)), 0.0, 255.0)
    gray = jnp.where(depth > 0, gray, 0.0)
    return gray, depth


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Twc with camera z pointing at `target` (vision convention: x right,
    y down, z forward). `up` default is world -y = image up."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, dtype=np.float64)
    x = np.cross(-up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def orbit_trajectory(n_frames: int, radius: float = 1.2, height_amp: float = 0.25,
                     loops: float = 1.0) -> np.ndarray:
    """A smooth closed orbit inside the room, looking outward at the walls.

    Closing the loop (loops=1.0) revisits the start pose — exercises loop
    closure. Returns Twc [N, 4, 4].
    """
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * loops * i / n_frames
        eye = np.array(
            [radius * np.cos(a), height_amp * np.sin(2 * a), radius * np.sin(a)],
            dtype=np.float64,
        )
        # look at a point on the wall ahead (tangential + outward)
        look_dir = np.array([-np.sin(a), 0.15 * np.cos(2 * a), np.cos(a)])
        target = eye + look_dir
        poses.append(look_at_pose(eye, target))
    return np.stack(poses)


def tour_trajectory(n_frames: int, loops: float = 1.0) -> np.ndarray:
    """A figure-eight tour through BOTH rooms of the multi-room world,
    crossing the doorway (x = 0) at z = 0 twice per revolution: the loop-
    closure case where the revisited place was left for a genuinely
    different one in between. Returns Twc [N, 4, 4]."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * loops * i / n_frames
        eye = np.array([
            4.2 * np.sin(a),
            0.25 * np.sin(2 * a),
            1.6 * np.sin(2 * a),
        ])
        tangent = np.array([
            4.2 * np.cos(a),
            0.5 * np.cos(2 * a),
            3.2 * np.cos(2 * a),
        ])
        tangent /= np.linalg.norm(tangent)
        poses.append(look_at_pose(eye, eye + tangent))
    return np.stack(poses)


def sweep_trajectory(n_frames: int, span: float = 1.6) -> np.ndarray:
    """A back-and-forth lateral sweep facing one wall — pure odometry case."""
    poses = []
    for i in range(n_frames):
        s = np.sin(2 * np.pi * i / n_frames)
        eye = np.array([span * s, 0.2 * np.sin(4 * np.pi * i / n_frames), -1.0])
        target = np.array([0.6 * span * s, 0.0, float(ROOM_HALF[2])])
        poses.append(look_at_pose(eye, target))
    return np.stack(poses)


@functools.partial(jax.jit, static_argnums=0)
def apply_sensor_noise(cam: Camera, gray: jnp.ndarray, depth: jnp.ndarray,
                       key: jnp.ndarray):
    """Kinect-class sensor corruption for realism testing:

    - image shot noise (sigma ~ 2 gray levels),
    - depth noise sigma_z = 0.0015 * z^2 — Khoshelham & Elberink's measured
      Kinect model (the reference's RANSAC gate deliberately over-estimates
      this as 0.01*z^2 "to be safe", Solver/SolverSE3.cpp:289-297; using the
      gate constant as actual noise is ~7x a real sensor and breaks any
      scalar-weighted 3D-3D estimator, the reference's included),
    - depth dropout speckles (~3% of pixels -> 0, like IR shadowing).
    """
    k1, k2, k3 = jax.random.split(key, 3)
    g = jnp.clip(gray + 2.0 * jax.random.normal(k1, gray.shape), 0.0, 255.0)
    sigma_z = 0.0015 * depth * depth
    d = depth + sigma_z * jax.random.normal(k2, depth.shape)
    dropout = jax.random.uniform(k3, depth.shape) < 0.03
    d = jnp.where(dropout | (depth <= 0), 0.0, jnp.maximum(d, 0.0))
    return g, d


class SyntheticDataset:
    """Dataset-interface wrapper over the renderer (IO/Dataset.h:11-39 analog).

    grab(i) -> (timestamp, gray [H,W] f32, depth [H,W] f32 meters).
    Ground truth available as `.poses_twc`. With noise=True, frames carry
    Kinect-like image/depth noise + depth dropouts (deterministic per index).
    """

    name = "SYNTH"

    def __init__(self, n_frames: int = 120, cam: Camera = SYNTHETIC,
                 trajectory: str = "orbit", fps: float = 30.0,
                 loops: float = 1.0, noise: bool = False, seed: int = 0):
        self.cam = cam
        self.fps = fps
        self.noise = noise
        self._seed = seed
        self._room_half = None
        self._boxes = None
        if trajectory == "orbit":
            self.poses_twc = orbit_trajectory(n_frames, loops=loops)
        elif trajectory == "sweep":
            self.poses_twc = sweep_trajectory(n_frames)
        elif trajectory == "tour":
            # multi-room world: two rooms, doorway wall, solid obstacles
            self.poses_twc = tour_trajectory(n_frames, loops=loops)
            self._room_half = MULTIROOM_HALF
            self._boxes = jnp.asarray(MULTIROOM_BOXES)
        else:
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.timestamps = np.arange(n_frames, dtype=np.float64) / fps

    def __len__(self) -> int:
        return len(self.poses_twc)

    def grab(self, i: int):
        gray, depth = render_frame(self.cam, jnp.asarray(self.poses_twc[i]),
                                   self._room_half, self._boxes)
        if self.noise:
            key = jax.random.fold_in(jax.random.PRNGKey(self._seed), i)
            gray, depth = apply_sensor_noise(self.cam, gray, depth, key)
        return self.timestamps[i], gray, depth
