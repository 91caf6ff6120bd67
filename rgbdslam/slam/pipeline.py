"""Pipelined odometry: B frames per device dispatch via lax.scan.

The host-orchestrated Tracker pays one dispatch round trip per frame; for
odometry-dominant workloads the whole frame chain is a scan — features for frame i, match against the carried
features of frame i-1, batched RANSAC — so B frames cost ONE dispatch. This
is the production serving shape: the native prefetcher stages frame batches
while the device chews the previous batch.

No keyframe/backend logic here (that's data-dependent control flow, kept on
host in slam/system.py); the output is the frame-to-frame transform chain,
composed into a trajectory.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.config import SlamConfig
from rgbdslam.frontend.frame import build_frame_features
from rgbdslam.frontend.matcher import gather_matched_points, match_frames
from rgbdslam.geometry.camera import Camera
from rgbdslam.solvers.icp import gicp_refine
from rgbdslam.solvers.ransac_se3 import ransac_se3


class PipelinedOdometry:
    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(),
                 batch: int = 8, seed: int = 0):
        self.cam = cam
        self.cfg = cfg
        self.batch = batch
        self._key = jax.random.PRNGKey(seed)
        ex_cfg, m_cfg, r_cfg = cfg.extractor, cfg.matcher, cfg.ransac
        icp_cfg, use_icp = cfg.icp, cfg.use_icp_refinement

        def multi_step(f_ref, grays, depths, key):
            def body(carry, inp):
                f_prev, k = carry
                g, d = inp
                k, sub = jax.random.split(k)
                f_cur = build_frame_features(cam, g, d, ex_cfg)
                m = match_frames(f_prev, f_cur, m_cfg.nn_ratio)
                p1, p2, w, valid = gather_matched_points(f_prev, f_cur, m)
                res = ransac_se3(p1, p2, w, valid, sub, r_cfg)
                T21 = res.T21
                if use_icp:
                    # GICP polish, as in the tracker (rmse-triggered; the
                    # branch is a select under scan)
                    T_g, conv, _ = gicp_refine(p1, p2, res.inliers, T21,
                                               None, icp_cfg,
                                               C1=f_prev.surf_cov,
                                               C2=f_cur.surf_cov[m.idx2])
                    use = (res.rmse >= icp_cfg.rmse_trigger) & conv & res.success
                    T21 = jnp.where(use, T_g, T21)
                return (f_cur, k), (T21, res.num_inliers, res.success)

            (f_fin, _), outs = jax.lax.scan(body, (f_ref, key), (grays, depths))
            return f_fin, outs

        # the jitted B-frame program: (f_ref, grays, depths, key) ->
        # (f_last, (T21s, num_inliers, success))
        self.step = jax.jit(multi_step)

    # ------------------------------------------------------------------
    def run(self, frames: Iterable[Tuple[float, np.ndarray, np.ndarray]]
            ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Process an iterable of (timestamp, gray, depth).

        Returns (timestamps [N], poses Twc [N, 4, 4], stats). Failed frames
        hold the previous relative pose at identity (recover() semantics).
        """
        frames = iter(frames)
        try:
            ts0, g0, d0 = next(frames)
        except StopIteration:
            return np.zeros((0,)), np.zeros((0, 4, 4), np.float32), {}

        f_ref = build_frame_features(self.cam, jnp.asarray(g0),
                                     jnp.asarray(d0), self.cfg.extractor)
        timestamps: List[float] = [ts0]
        Tcw = np.eye(4, dtype=np.float32)
        poses: List[np.ndarray] = [np.linalg.inv(Tcw)]
        failures = 0
        inliers_sum = 0
        n_frames = 1

        batch_ts: List[float] = []
        batch_g: List[np.ndarray] = []
        batch_d: List[np.ndarray] = []

        def flush():
            nonlocal f_ref, Tcw, failures, inliers_sum, n_frames
            if not batch_ts:
                return
            B = len(batch_ts)
            # pad the trailing partial batch by repeating the last frame
            # (results for padding are discarded)
            while len(batch_g) < self.batch:
                batch_g.append(batch_g[-1])
                batch_d.append(batch_d[-1])
            grays = jnp.stack([jnp.asarray(g) for g in batch_g])
            depths = jnp.stack([jnp.asarray(d) for d in batch_d])
            self._key, sub = jax.random.split(self._key)
            f_ref, (T21s, ninls, oks) = self.step(f_ref, grays, depths, sub)
            T21s, ninls, oks = jax.device_get((T21s, ninls, oks))
            for i in range(B):
                if bool(oks[i]):
                    Tcw = (T21s[i] @ Tcw).astype(np.float32)
                    inliers_sum += int(ninls[i])
                else:
                    failures += 1
                timestamps.append(batch_ts[i])
                poses.append(np.linalg.inv(Tcw))
                n_frames += 1
            batch_ts.clear()
            batch_g.clear()
            batch_d.clear()

        for ts, g, d in frames:
            batch_ts.append(ts)
            batch_g.append(g)
            batch_d.append(d)
            if len(batch_ts) == self.batch:
                flush()
        flush()

        stats = {
            "frames": n_frames,
            "failures": failures,
            "mean_inliers": inliers_sum // max(n_frames - 1, 1),
        }
        return np.asarray(timestamps), np.stack(poses), stats
