"""Data-parallel multi-sequence odometry over a device mesh.

The offline-mapping serving shape: S independent RGB-D sequences (or S
segments of one long sequence), each processed by the pipelined odometry
scan (slam/pipeline.py), sharded over the mesh's `seq` axis with
`shard_map` — zero collectives, linear scaling (the per-sequence frame
chain is sequential, sequences are not).

The reference has no analog (single-process, single-sequence; SURVEY.md
§2.7 P7 'absent'); this is the capability a device mesh adds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rgbdslam.config import SlamConfig
from rgbdslam.frontend.frame import build_frame_features
from rgbdslam.frontend.matcher import gather_matched_points, match_frames
from rgbdslam.geometry.camera import Camera


def make_seq_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _sequence_odometry(cam: Camera, cfg: SlamConfig):
    """(grays [T,H,W], depths [T,H,W], key) -> (T21 chain [T-1,4,4],
    inliers [T-1]) — one sequence, lax.scan over frames (the pipelined
    odometry body without the host loop)."""
    from rgbdslam.solvers.icp import gicp_refine
    from rgbdslam.solvers.ransac_se3 import ransac_se3

    def run(grays, depths, key):
        f0 = build_frame_features(cam, grays[0], depths[0], cfg.extractor)

        def body(carry, inp):
            f_prev, k = carry
            g, d = inp
            k, sub = jax.random.split(k)
            f_cur = build_frame_features(cam, g, d, cfg.extractor)
            m = match_frames(f_prev, f_cur, cfg.matcher.nn_ratio)
            p1, p2, w, valid = gather_matched_points(f_prev, f_cur, m)
            res = ransac_se3(p1, p2, w, valid, sub, cfg.ransac)
            T21 = res.T21
            if cfg.use_icp_refinement:
                T_g, conv, _ = gicp_refine(
                    p1, p2, res.inliers, T21, None, cfg.icp,
                    C1=f_prev.surf_cov, C2=f_cur.surf_cov[m.idx2])
                use = (res.rmse >= cfg.icp.rmse_trigger) & conv & res.success
                T21 = jnp.where(use, T_g, T21)
            return (f_cur, k), (T21, res.num_inliers)

        (_, _), (T21s, ninl) = jax.lax.scan(
            body, (f0, key), (grays[1:], depths[1:])
        )
        return T21s, ninl

    return run


def dp_odometry(cam: Camera, cfg: SlamConfig, mesh: Mesh, axis: str = "seq"):
    """Returns a jitted fn (grays [S,T,H,W], depths [S,T,H,W], keys [S,2])
    -> (T21 [S,T-1,4,4], inliers [S,T-1]) with S sharded over `axis`.

    S must be a multiple of the mesh size; each device runs its local
    sequences with an inner vmap. No collectives enter the program.
    """
    seq_fn = _sequence_odometry(cam, cfg)

    def local(grays, depths, keys):
        return jax.vmap(seq_fn)(grays, depths, keys)

    spec = P(axis)
    # check_vma=False: the fused Pallas detect kernel's out_shape carries no
    # varying-mesh-axes annotation; every array here is seq-sharded anyway
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)


def compose_chain(T21s: np.ndarray) -> np.ndarray:
    """Frame-to-frame chains -> absolute Tcw trajectories.

    T21s: (..., T-1, 4, 4); returns (..., T, 4, 4) with Tcw[0] = I and
    Tcw[t] = T21[t-1] @ Tcw[t-1] (Solver/SolverSE3.cpp:124-126 convention).
    """
    T21s = np.asarray(T21s)
    lead = T21s.shape[:-3]
    T = T21s.shape[-3] + 1
    out = np.tile(np.eye(4, dtype=T21s.dtype), lead + (T, 1, 1))
    for t in range(1, T):
        out[..., t, :, :] = T21s[..., t - 1, :, :] @ out[..., t - 1, :, :]
    return out
