"""Full SLAM system: tracking + pose-graph backend + loop closure.

Array-program re-design of the reference's 3-thread runtime (SURVEY.md §2.7
P1-P4): the PoseGraph thread's polling loop (Solver/PoseGraph.cpp:59-103)
becomes a synchronous, functional backend step invoked per keyframe — state
handoff is explicit (arrays in, arrays out) instead of a mutex-guarded queue +
cross-thread callback. The heavy work (pairwise matching, RANSAC verification,
the Gauss-Newton graph solve, BoW scoring) runs as jitted device programs.

Backend step per keyframe (updateGraph semantics, Solver/PoseGraph.cpp:105-126):
  1. add vertex (Twc), odometry edge to the previous KF
     (createEdgeWithReference, info=100*I, from-state measurement),
  2. proximity edges: radius search over KF centers (0.5 m), candidates
     verified by match (>=30) + RANSAC before a measured edge is added
     (createLocalEdges, Solver/PoseGraph.cpp:128-184),
  3. loop detection: gated (>=15 KFs since last loop), BoW candidates,
     match threshold 0.2 * mean tracking inliers, RANSAC verification
     (detectLoop, Solver/PoseGraph.cpp:245-287),
  4. on a loop: optimize(20), write corrected poses back into the keyframe
     store and the tracker (Tracking::correct / Frame::correctPose semantics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.config import SlamConfig
from rgbdslam.frontend.frame import FrameFeatures
from rgbdslam.frontend.matcher import (correspondence_weights,
                                       match_descriptors)
from rgbdslam.geometry.camera import Camera
from rgbdslam.geometry import se3
from rgbdslam.loop.detector import LoopDetector
from rgbdslam.mapping.keyframes import KeyframeStore
from rgbdslam.slam.tracking import Tracker
from rgbdslam.solvers.pose_graph import PoseGraph
from rgbdslam.solvers.ransac_se3 import ransac_se3
from rgbdslam.utils.rpccount import RPC


import functools


@functools.lru_cache(maxsize=32)
def _system_programs(cam: Camera, cfg: SlamConfig) -> dict:
    """Jitted backend programs for one (camera, config) pair, SHARED across
    SlamSystem instances (tracing/lowering costs seconds; see
    tracking._tracker_programs for the measurement). All closures are pure
    functions of their arguments + the frozen (cam, cfg) cache key."""
    matcher_cfg, ransac_cfg = cfg.matcher, cfg.ransac
    # the fused keyframe program packs track-extension results as
    # idx2 + 4096*ok in one f32 lane (decoded with & 4095 / >= 4096 in
    # _kf_complete); a feature budget beyond 4096 would silently corrupt
    # the packed indices (ADVICE r4)
    assert cfg.extractor.num_features <= 4096, (
        "num_features > 4096 breaks the packed track-extension lane")

    # batched candidate verification: match + RANSAC vmapped over C
    # candidate keyframes against the current frame in a single device
    # program — the sequential per-candidate loop costs C x 2 dispatch
    # round trips
    def _verify_one(desc_i, xyz_i, valid_i, desc_k, xyz_k, valid_k, key):
        m = match_descriptors(desc_i, valid_i, desc_k, valid_k,
                              matcher_cfg.nn_ratio)
        mvalid = m.valid & valid_k[m.idx2]
        p1 = xyz_i
        p2 = xyz_k[m.idx2]
        w = correspondence_weights(p1, p2, mvalid)
        n_matches = jnp.sum(mvalid)
        res = ransac_se3(p1, p2, w, mvalid, key, ransac_cfg)
        return res.T21, res.num_inliers, res.success, n_matches

    def _verify_bank(D, X, V, idx, desc_k, xyz_k, valid_k, key):
        """Verify bank KFs `idx` (C,) against the current frame; returns
        (C, 19) packed rows [T21(16) | num_inliers | success | n_matches]
        — one fetch for the whole candidate set."""
        keys = jax.random.split(key, idx.shape[0])
        T, ninl, ok, nm = jax.vmap(
            lambda i, kk: _verify_one(D[i], X[i], V[i],
                                      desc_k, xyz_k, valid_k, kk)
        )(idx, keys)
        return jnp.concatenate(
            [T.reshape(-1, 16),
             jnp.stack([ninl.astype(jnp.float32),
                        ok.astype(jnp.float32),
                        nm.astype(jnp.float32)], axis=1)],
            axis=1,
        )

    # landmark-track extension, fused: match the previous KF (from the
    # bank) into the current frame + the geometric/reprojection gates,
    # all on device; ONE (2, N) fetch replaces a match fetch + host
    # projection math
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    gate_px = cfg.track_gate_px

    def _extend_tracks(D, X, V, kprev, desc_k, xyz_k, valid_k, uv_k, T21):
        Dp, Xp, Vp = D[kprev], X[kprev], V[kprev]
        m = match_descriptors(Dp, Vp, desc_k, valid_k,
                              matcher_cfg.nn_ratio)
        # geometric gate on track extension: the relative KF pose is
        # known, so a correct association must map the old 3-D point
        # onto the new one (rejects descriptor aliasing). The metric
        # gate alone admits BA-poisoning associations (0.10 m at z=2 m
        # is a 10 px reprojection error for fx=200), so a pixel gate
        # on the predicted reprojection is applied as well.
        pred = Xp @ T21[:3, :3].T + T21[:3, 3]
        err = jnp.linalg.norm(pred - xyz_k[m.idx2], axis=-1)
        z = jnp.maximum(pred[:, 2], 1e-6)
        u_pred = fx * pred[:, 0] / z + cx
        v_pred = fy * pred[:, 1] / z + cy
        uv_cur = uv_k[m.idx2]
        err_px = jnp.hypot(u_pred - uv_cur[:, 0], v_pred - uv_cur[:, 1])
        ok = (m.valid & (err < 0.10) & (err_px < gate_px)
              & (pred[:, 2] > 0.05))
        return jnp.stack([m.idx2.astype(jnp.int32), ok.astype(jnp.int32)])

    # --- fused keyframe program -----------------------------------------
    # ALL per-keyframe device work in ONE dispatch + ONE blob fetch:
    # bank insertion, host-store packing, batched proximity
    # verification, landmark-track extension, BoW quantization + database
    # scores. The unfused flow paid 6-8 separate host<->device round trips
    # per keyframe.
    _C = cfg.pose_graph.max_proximity_candidates

    _L = cfg.loop.max_candidates
    _interval = cfg.loop.id_interval

    def _kf_core(D, X, V, B, f, meta, words, idf, key, bow_on):
        """meta: ONE (3 + C + 16,) f32 array carrying every host scalar
        [k, kprev, n_cands, idx(C), T21.ravel(16)] — each separate host
        argument would pay its own device_put round trip.
        The PRNG key evolves on device and is returned.

        Blob layout (all f32): with bow_on (a vocabulary is live — the
        deployment shape) the SLIM pack ships — (N,4) features WITHOUT
        descriptors, packed track-extension (N,), then (C+L,19)
        verification rows covering BOTH the proximity candidates and the
        BoW loop candidates selected ON DEVICE (below), then the L selected
        loop indices + validity. Descriptors/BoW vectors stay in the device
        bank and hydrate lazily (SlamSystem.hydrate_host). Without bow_on
        (online codebook still training) the full (N, nd+8) pack ships and
        there is no loop section (loop closure needs a codebook anyway).

        On-device obtainCandidates (PlaceRecognition/LoopDetector.cpp:28-84
        semantics): floor = min BoW score over the connected set, candidates
        must beat the floor, respect the id interval, and not be connected;
        top-L by score. The connected set here is {kprev} + the proximity
        candidates in `idx`. For a brand-new query keyframe this IS the
        complete host-known connection set (ADVICE r4 checked): the query's
        connections are CREATED by this very program's verification rows —
        loop_detector._connections[k] does not exist before _kf_complete,
        and prior loop closures connect OLDER keyframe pairs, which the
        reference's skip-connected rule (LoopDetector.cpp:37-46, keyed on
        the query's own mspConnectedKFs) would not exclude either. The one
        divergence is a superset exclusion: a proximity candidate whose
        RANSAC verification FAILS later in this program is still excluded
        from candidacy/floor, whereas the reference would admit it — it sits
        inside the 0.5 m proximity radius, where revisits are handled by
        proximity edges, and the host graph.has_edge gate dedupes in any
        case. Selected candidates are verified IN THIS PROGRAM, so loop
        closure costs ZERO extra round trips — detectLoop rides the same
        dispatch+fetch as the rest of the keyframe."""
        from rgbdslam.frontend.frame import (pack_features_for_host,
                                             pack_features_slim)
        from rgbdslam.loop.bow import bow_scores, bow_vector

        k = meta[0].astype(jnp.int32)
        kprev = meta[1].astype(jnp.int32)
        n_cands = meta[2].astype(jnp.int32)
        idx = meta[3:3 + _C].astype(jnp.int32)
        T21 = meta[3 + _C:].reshape(4, 4)
        key, sub = jax.random.split(key)
        D = D.at[k].set(f.desc)
        X = X.at[k].set(f.xyz)
        V = V.at[k].set(f.obs_valid)
        ps = pack_features_slim(f) if bow_on else pack_features_for_host(f)
        ext = _extend_tracks(D, X, V, kprev, f.desc, f.xyz,
                             f.obs_valid, f.uv_undist, T21)
        # idx2 + 4096*ok packed into one f32 lane (exact: < 2^24)
        ext_packed = (ext[0] + 4096 * ext[1]).astype(jnp.float32)

        if bow_on:
            vec = bow_vector(f.desc, f.obs_valid, words, idf)
            B = B.at[k].set(vec)
            scores = bow_scores(vec, B)                     # (Kbank,)
            Kb = B.shape[0]
            j_iota = jnp.arange(Kb)
            slot_valid = jnp.arange(_C) < n_cands
            conn = (j_iota == kprev) | jnp.any(
                (j_iota[None, :] == idx[:, None]) & slot_valid[:, None],
                axis=0)
            floor = jnp.min(jnp.where(conn, scores, jnp.inf))
            cand_ok = ((j_iota < k) & ((k - j_iota) > _interval)
                       & ~conn & (scores > floor))
            s_masked = jnp.where(cand_ok, scores, -1.0)
            _top_s, top_j = jax.lax.top_k(s_masked, _L)
            loop_valid = _top_s > -0.5
            all_idx = jnp.concatenate([idx, top_j.astype(jnp.int32)])
            ver = _verify_bank(D, X, V, all_idx,
                               f.desc, f.xyz, f.obs_valid, sub)
            parts = [ps.reshape(-1), ext_packed, ver.reshape(-1),
                     top_j.astype(jnp.float32),
                     loop_valid.astype(jnp.float32)]
        else:
            ver = _verify_bank(D, X, V, idx,
                               f.desc, f.xyz, f.obs_valid, sub)
            parts = [ps.reshape(-1), ext_packed, ver.reshape(-1)]
        return D, X, V, B, key, jnp.concatenate(parts)

    def _kf_core_batched(D, X, V, B, feats, meta, words, idf, key, bow_on):
        """Batched-tracking variant: `feats` is the whole (B, ...) scan
        output and meta[-1] the in-batch row — the gather happens INSIDE
        this program, removing the per-keyframe slice launch the round-3
        host loop paid (VERDICT r3 weak/host item 4)."""
        i = meta[-1].astype(jnp.int32)
        f = jax.tree.map(lambda x: x[i], feats)
        return _kf_core(D, X, V, B, f, meta[:-1], words, idf, key,
                        bow_on=bow_on)

    return {
        "verify_bank": jax.jit(_verify_bank),
        "extend_tracks": jax.jit(_extend_tracks),
        "kf_fused": {
            flag: jax.jit(functools.partial(_kf_core, bow_on=flag),
                          donate_argnums=(0, 1, 2, 3))
            for flag in (False, True)
        },
        "kf_fused_batched": {
            flag: jax.jit(functools.partial(_kf_core_batched, bow_on=flag),
                          donate_argnums=(0, 1, 2, 3))
            for flag in (False, True)
        },
    }


class SlamSystem:
    def __init__(self, cam: Camera, cfg: SlamConfig = SlamConfig(), seed: int = 0):
        self.cam = cam
        self.cfg = cfg
        kf_cfg = cfg.keyframe
        self.tracker = Tracker(cam, cfg, seed=seed)
        self.store = KeyframeStore(kf_cfg.max_keyframes, cfg.extractor.num_features)
        self.graph = PoseGraph(
            kf_cfg.max_keyframes,
            cfg.pose_graph.max_edges,
            information=cfg.pose_graph.edge_information,
            huber_delta=cfg.pose_graph.huber_delta,
            cg_threshold=cfg.pose_graph.cg_vertex_threshold,
            cg_iters=cfg.pose_graph.cg_iters,
            lm_lambda0=cfg.pose_graph.lm_lambda0,
        )
        # distributed backend (SlamConfig.distributed): the live solves ride
        # a 1-D mesh over every visible device — pose-graph edges sharded in
        # PoseGraph.optimize, global-BA landmarks sharded in _global_ba
        self._mesh = None
        if cfg.distributed and jax.device_count() > 1:
            from rgbdslam.parallel.dist_ba import make_mesh

            self._mesh = make_mesh()
            self.graph.mesh = self._mesh
        self.loop_detector = LoopDetector(cfg.loop, kf_cfg.max_keyframes, seed=seed)
        from rgbdslam.mapping.landmarks import LandmarkStore

        self.landmarks = LandmarkStore(
            cfg.max_landmarks, cfg.max_obs_per_landmark,
            cfg.extractor.num_features,
        )
        self.kfs_since_loop = 0
        self.loops_closed = 0
        self.loop_solve_ms = []   # wall ms of each mid-run loop-closure
                                  # optimize(20) (Solver/PoseGraph.cpp:71)
        self.last_loop_candidates = 0   # viewer HUD counter analog
                                        # (Tracking::loopCandidates,
                                        #  Drawer/Viewer.cpp:113-120)
        # during-run visualization: (every_n_keyframes, out_dir) -> rewrite
        # map_viewer.html + trajectory.png + tracked-point overlay.png +
        # (epoch-gated) octomap.npz periodically (the offline analog of the
        # reference's 3 ms Pangolin render poll, Drawer/Viewer.cpp:83-136 +
        # the live overlay texture Viewer.cpp:122-128 + the big-change
        # octomap rebuild MapDrawer.cpp:48-71); amortized, off the
        # per-frame hot path
        self.live_export = None
        self.live_exports_written = 0
        self.live_exports_dropped = 0   # worker-busy skips (render-poll
                                        # frame drops)
        self._live_q = None
        self._live_thread = None
        self._live_last_t = -1e18       # wall-clock export-floor state
        self._live_final = False        # finish()'s export bypasses floors
        # big-change epoch (Map::informNewBigChange, Core/Map.cpp:134-144):
        # bumped after each loop-closure optimization; the live exporter
        # rebuilds the occupancy grid only when it advances
        self.map_epoch = 0
        self._live_occ_epoch = -1     # epoch of the last octomap.npz write
        self._live_occ_builder = None  # worker-thread incremental grid
        self._live_keeper = None      # KF (gray, depth) refs, live mode only
        self._live_overlay = None     # (gray, uv, valid, track_inlier) of
                                      # the latest keyframe
        self._recent_frames = {}      # ts -> (gray, depth) refs, last ~40
        self._key = jax.random.PRNGKey(seed + 12345)
        # keyframe rows whose descriptors/BoW vectors were NOT shipped in
        # the slim blob — hydrated from the device bank on demand
        self._lazy_rows = set()
        self.tracker.on_keyframe = self._on_keyframe
        # pipelined variant for batched tracking: dispatch every keyframe of
        # a batch back-to-back, complete them after one stacked blob fetch
        self.tracker.on_keyframe_dispatch = self._kf_dispatch
        self.tracker.on_keyframe_complete = self._kf_complete
        if cfg.use_relocalization:
            self.tracker.relocalize_fn = self._relocalize

        # --- device-resident keyframe bank ---------------------------------
        # Descriptors / 3-D points / validity / BoW vectors stay ON DEVICE
        # across the run: backend work gathers candidates from the bank by
        # index, so per keyframe there is no host->device re-upload of
        # feature tables and results come back as ONE packed blob (each
        # separate transfer is its own blocking copy).
        self._bank = None     # (desc [K,N,*], xyz [K,N,3], valid [K,N],
                              #  bow [K,V])
        self._bow_dev = None  # (words, idf) device copies once trained

        # backend device programs from the shared (cam, cfg) cache — see
        # _system_programs
        progs = _system_programs(cam, cfg)
        self._verify_bank_fn = progs["verify_bank"]
        self._extend_tracks = progs["extend_tracks"]
        self._kf_fused = progs["kf_fused"]
        self._kf_fused_batched = progs["kf_fused_batched"]

    # ------------------------------------------------------------------
    def _remember_frame(self, ts, gray, depth):
        """Live-export frame retention: keep REFERENCES (no copy, no fetch)
        to the last ~40 frames so a keyframe's own image can be paired with
        its features for the overlay + occupancy keeper (matched by
        timestamp in _kf_complete — mode-agnostic across serial/ring/batch
        tracking)."""
        if self.live_export is None:
            return
        self._recent_frames[float(ts)] = (gray, depth)
        if len(self._recent_frames) > 40:
            for t in sorted(self._recent_frames)[:-40]:
                del self._recent_frames[t]

    def track(self, timestamp: float, gray, depth) -> np.ndarray:
        self._remember_frame(timestamp, gray, depth)
        return self.tracker.track(timestamp, gray, depth)

    def track_batch(self, timestamps, grays, depths) -> np.ndarray:
        """B frames per device dispatch (scan-fused VO + on-device keyframe
        gate; the backend still runs per flagged keyframe). Returns
        (B, 4, 4) Tcw."""
        return self.tracker.track_batch(timestamps, grays, depths)

    def track_batch_dispatch(self, timestamps, grays, depths) -> dict:
        """Double-buffered deployment shape: dispatch batch i+1 BEFORE
        completing batch i so the blob-fetch RPCs of one batch overlap the
        device compute of the next (the reference's tracking/backend thread
        overlap, main.cpp:39-48)."""
        for ts, g, d in zip(timestamps, grays, depths):
            self._remember_frame(ts, g, d)
        return self.tracker.track_batch_dispatch(timestamps, grays, depths)

    def track_batch_complete(self, h: dict) -> np.ndarray:
        return self.tracker.track_batch_complete(h)

    def track_pipelined(self, timestamp: float, gray, depth):
        """Per-frame tracking through the depth-2 dispatch/fetch ring
        (ONE blocking fetch per frame; keyframe backend completes one frame
        late). Returns the previous frame's (ts, Tcw), or None."""
        self._remember_frame(timestamp, gray, depth)
        return self.tracker.track_pipelined(timestamp, gray, depth)

    def track_pipelined_flush(self):
        return self.tracker.track_pipelined_flush()

    # ------------------------------------------------------------------
    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _ensure_bank(self, n_feat: int, desc_shape, desc_dtype):
        if self._bank is None:
            K = self.cfg.keyframe.max_keyframes
            self._bank = (
                jnp.zeros((K,) + tuple(desc_shape), desc_dtype),
                jnp.zeros((K, n_feat, 3), jnp.float32),
                jnp.zeros((K, n_feat), bool),
                # BoW width follows the detector's codebook (vocab_width is
                # the single source of truth; a preloaded vocabulary may
                # differ from LoopConfig.vocab_size)
                jnp.zeros((K, self.loop_detector.vocab_width), jnp.float32),
            )

    def load_vocabulary(self, path: str) -> None:
        """Load a pre-trained vocabulary (the reference's startup load,
        main.cpp:15,32) and sync the device codebook + BoW bank so the very
        next keyframe quantizes on device at the loaded width."""
        ld = self.loop_detector
        ld.load_vocabulary(path)
        self._bow_dev = (jnp.asarray(ld.words), jnp.asarray(ld.idf))
        if self._bank is not None:
            Kb = self._bank[0].shape[0]
            B = np.zeros((Kb, ld.vocab_width), np.float32)
            rows = min(Kb, ld.bow_db.shape[0])
            B[:rows] = ld.bow_db[:rows]
            self._bank = self._bank[:3] + (jnp.asarray(B),)

    def hydrate_host(self):
        """Fetch the lazily-deferred descriptor + BoW rows from the device
        bank into the host mirrors (slim-blob mode ships neither; VERDICT r3
        item 2). One gather dispatch + two fetches regardless of how many
        keyframes are pending — called by the rare host consumers
        (checkpoint save, map merge), never on the tracking hot path."""
        if not self._lazy_rows or self._bank is None:
            return
        ks = np.asarray(sorted(self._lazy_rows), np.int32)
        D, B = self._bank[0], self._bank[3]
        idx = jnp.asarray(ks)
        RPC.dispatches += 2
        desc_rows = RPC.fetch(D[idx])
        bow_rows = RPC.fetch(B[idx])
        store = self.store
        if (store.desc.shape[1:] != desc_rows.shape[1:]
                or store.desc.dtype != desc_rows.dtype):
            store.desc = np.zeros(
                (store.max_keyframes,) + desc_rows.shape[1:],
                dtype=desc_rows.dtype)
        ld = self.loop_detector
        w = min(bow_rows.shape[1], ld.bow_db.shape[1])
        for i, k in enumerate(ks):
            store.desc[k] = desc_rows[i]
            if k < ld.bow_db.shape[0]:
                ld.bow_db[k, :w] = bow_rows[i, :w]
        self._lazy_rows.clear()

    def rebuild_bank_from_store(self):
        """Re-sync the device-resident keyframe bank (descriptors, points,
        validity, BoW vectors) from the host store — required after a
        checkpoint resume (utils/serialization.load_map), which restores the
        host arrays only: without this, proximity/loop/relocalization
        verification would match new frames against an all-zeros bank for
        every pre-load keyframe."""
        if self.store.count == 0:
            return
        ld = self.loop_detector
        # stores grow independently; the bank takes the keyframe store's K
        # and pads/truncates the BoW table rows to match
        Kb = self.store.max_keyframes
        B = np.zeros((Kb, ld.vocab_width), np.float32)
        rows = min(Kb, ld.bow_db.shape[0])
        B[:rows] = ld.bow_db[:rows, : ld.vocab_width]
        self._bank = (
            jnp.asarray(self.store.desc),
            jnp.asarray(self.store.xyz),
            jnp.asarray(self.store.obs_valid),
            jnp.asarray(B),
        )
        if ld.words is not None:
            self._bow_dev = (jnp.asarray(ld.words), jnp.asarray(ld.idf))

    def _verify_candidates(self, cands, f):
        """Batched match+RANSAC of bank KFs `cands` against frame `f` via the
        device bank; returns host arrays (T21 (C,4,4), ninl, ok, n_matches)
        for the first len(cands) rows — a single device call + ONE fetch.

        RansacSE3 runs with F1=candidate KF, F2=f, so T21[c] = T_{f<-cand_c}.
        Padding rows (idx 0) are fetched but ignored by the callers."""
        packed = RPC.fetch(self._verify_dispatch(cands, f))
        return self._verify_decode(packed)

    def _verify_dispatch(self, cands, f):
        """Dispatch-only half of _verify_candidates: returns the device
        (C, 19) packed result (no fetch)."""
        C = self.cfg.pose_graph.max_proximity_candidates
        idx = np.zeros((C,), np.int32)
        idx[: len(cands)] = cands
        D, X, V = self._bank[:3]
        RPC.dispatches += 1
        return self._verify_bank_fn(
            D, X, V, jnp.asarray(idx), f.desc, f.xyz, f.obs_valid,
            self._next_key(),
        )

    @staticmethod
    def _verify_decode(packed: np.ndarray):
        T = packed[:, :16].reshape(-1, 4, 4)
        ninl = packed[:, 16].astype(np.int32)
        ok = packed[:, 17] > 0.5
        nm = packed[:, 18].astype(np.int32)
        return T, ninl, ok, nm

    def _on_keyframe(self, k: int, timestamp: float, f: FrameFeatures,
                     Tcw: np.ndarray):
        """Backend step per keyframe: ONE fused device dispatch + ONE blob
        fetch covers bank insertion, store packing, proximity verification,
        track extension and BoW scoring; everything after is host numpy and
        the (rare) loop-closure solves."""
        h = self._kf_dispatch(k, timestamp, f, Tcw)
        self._kf_complete(h, RPC.fetch(h["blob"]))

    def _kf_dispatch(self, k: int, timestamp: float, f: FrameFeatures,
                     Tcw: np.ndarray, feats_batch=None,
                     batch_row: int = 0) -> dict:
        """Dispatch phase: register the keyframe's pose (so same-batch
        successors see it in radius searches and edge dedup), compute the
        proximity candidates, and launch the fused device program — no
        fetch. Batched tracking dispatches every keyframe of a batch
        back-to-back (the donated bank chains them on device) and fetches
        all blobs in one stacked transfer.

        `feats_batch`/`batch_row`: batched-tracking form — `f` is row
        `batch_row` of the (B, ...) scan output `feats_batch`, gathered
        INSIDE the fused program (no per-KF slice launch); `f` itself must
        then be a single-row template (any row) used only for shape/dtype.
        """
        pg_cfg = self.cfg.pose_graph
        if feats_batch is None:
            N = f.uv.shape[0]
            desc_shape, desc_dtype = tuple(f.desc.shape), f.desc.dtype
        else:
            N = feats_batch.uv.shape[1]
            desc_shape = tuple(feats_batch.desc.shape[1:])
            desc_dtype = feats_batch.desc.dtype
        binary_desc = desc_dtype == jnp.uint32
        self._ensure_bank(N, desc_shape, desc_dtype)
        if k >= self._bank[0].shape[0]:
            # budget-doubling for the device-resident bank (SURVEY.md §7 hard
            # part (e)): one concat per power-of-two bucket; the fused KF /
            # verification programs recompile once per doubling
            self._bank = tuple(
                jnp.concatenate([a, jnp.zeros_like(a)], axis=0)
                for a in self._bank)
        bow_on = self._bow_dev is not None

        store_k = self.store.register(timestamp, Tcw)
        assert store_k == k
        vk = self.graph.add_vertex(se3.inverse_np(Tcw))
        assert vk == k
        connections = set()
        if k > 0:
            # odometry edge (createEdgeWithReference)
            self.graph.add_odometry_edge(k, k - 1)
            connections.add(k - 1)

        # proximity candidates (createLocalEdges' radius search) from host
        # poses — the kd-tree replacement (Solver/PoseGraph.cpp:157-184)
        cands = []
        if k > 0:
            ck = -Tcw[:3, :3].T @ Tcw[:3, 3]
            c_all = self.store.centers()[:k]
            d = np.linalg.norm(c_all - ck, axis=-1)
            order = np.argsort(d)
            cands = [int(j) for j in order
                     if d[j] <= pg_cfg.proximity_radius and j != k - 1
                     and not self.graph.has_edge(k, j)]
            cands = cands[: pg_cfg.max_proximity_candidates]
        C = pg_cfg.max_proximity_candidates
        T21_prev = (Tcw @ se3.inverse_np(self.store.poses_cw[k - 1])
                    if k > 0 else np.eye(4, dtype=np.float32))
        # ONE host->device transfer for every scalar the program needs
        meta = np.zeros((3 + C + 16,), np.float32)
        meta[0] = k
        meta[1] = max(k - 1, 0)
        meta[2] = len(cands)
        meta[3:3 + len(cands)] = cands
        meta[3 + C:] = T21_prev.astype(np.float32).ravel()

        D, X, V, B = self._bank
        if bow_on:
            words, idf = self._bow_dev
        else:
            words = idf = jnp.zeros((1,), jnp.float32)
        if feats_batch is None:
            D, X, V, B, self._key, blob = self._kf_fused[bow_on](
                D, X, V, B, f, meta, words, idf, self._key,
            )
        else:
            meta_b = np.concatenate(
                [meta, np.float32([batch_row])]).astype(np.float32)
            D, X, V, B, self._key, blob = self._kf_fused_batched[bow_on](
                D, X, V, B, feats_batch, meta_b, words, idf, self._key,
            )
        RPC.dispatches += 1
        self._bank = (D, X, V, B)
        return {"k": k, "ts": timestamp, "f": f, "Tcw": Tcw, "cands": cands,
                "connections": connections, "bow_on": bow_on,
                "binary": binary_desc, "N": N,
                "nd": desc_shape[-1], "blob": blob}

    def _kf_complete(self, h: dict, blob: np.ndarray):
        """Completion phase: host bookkeeping from the fetched blob —
        store rows, proximity edges, BoW registration, landmark tracks,
        loop detection and the (rare) solves."""
        k = h["k"]
        Tcw = h["Tcw"]
        cands = h["cands"]
        connections = h["connections"]
        bow_on = h["bow_on"]
        binary_desc = h["binary"]
        N, nd = h["N"], h["nd"]
        pg_cfg = self.cfg.pose_graph
        C = pg_cfg.max_proximity_candidates

        L = self.cfg.loop.max_candidates
        if bow_on:
            off = N * 4                   # slim pack (no descriptors)
            ps = blob[:off].reshape(N, 4)
        else:
            off = N * (nd + 8)
            ps = blob[:off].reshape(N, nd + 8)
        extp = blob[off:off + N]          # idx2 + 4096*ok, one f32 lane
        off += N
        n_ver = C + L if bow_on else C    # loop rows ride the same blob
        ver = blob[off:off + n_ver * 19].reshape(n_ver, 19)
        off += n_ver * 19
        loop_j = loop_valid = None
        if bow_on:
            loop_j = blob[off:off + L].astype(np.int32)
            loop_valid = blob[off + L:off + 2 * L] > 0.5

        if bow_on:
            self.store.fill_features_slim(k, ps, self.cam)
            self._lazy_rows.add(k)        # desc + BoW row hydrate on demand
        else:
            self.store.fill_features(k, ps, nd, binary_desc)
        self.kfs_since_loop += 1

        # proximity edges (createLocalEdges)
        T_b = ver[:, :16].reshape(-1, 4, 4)
        ninl_b = ver[:, 16].astype(np.int32)
        ok_b = ver[:, 17] > 0.5
        nm_b = ver[:, 18].astype(np.int32)
        for c, j in enumerate(cands):
            if not ok_b[c]:
                continue
            if nm_b[c] < pg_cfg.proximity_min_matches:
                continue
            if ninl_b[c] < pg_cfg.proximity_min_matches:
                continue
            # RansacSE3(F1=j, F2=k) yields T with p_k = T p_j = T_{k<-j};
            # edge (a=k, b=j) needs Z = T_{a<-b} in Twc-vertex convention:
            # Z = X_k^-1 X_j = Tcw_k Twc_j = T_{k<-j}. Matches the
            # reference wiring (Solver/PoseGraph.cpp:147-153).
            self.graph.add_edge(k, j, np.asarray(T_b[c]))
            connections.add(j)
            self.loop_detector.connect(k, j)

        # BoW registration: pre-training the host path accumulates
        # descriptors (already fetched into the store — no extra device
        # reads); once the codebook exists, the fused program quantizes the
        # vector on device, keeps it in the device bank, and the host row
        # hydrates lazily (hydrate_host) if checkpointing/merge asks.
        # Binary families train a k-majority codebook, float (SIFT/SURF)
        # families an L2 k-means one (loop/codebook.py) — every descriptor
        # family keeps loop closure (beyond the reference: DBoW3 is
        # binary-only).
        if bow_on:
            self.loop_detector.add_precomputed(None, connections)
        else:
            self.loop_detector.add(self.store.desc[k],
                                   self.store.obs_valid[k], connections)
            if self.loop_detector.words is not None:
                # codebook now available (just trained, or preloaded before
                # the first keyframe): push device copies + backfill the
                # device BoW bank with the host table
                self._bow_dev = (jnp.asarray(self.loop_detector.words),
                                 jnp.asarray(self.loop_detector.idf))
                self._bank = self._bank[:3] + (
                    jnp.asarray(self.loop_detector.bow_db),)

        # landmark-track extension (Landmark::addObservation analog),
        # already computed on device by the fused program
        match_idx = match_valid = None
        if k > 0:
            match_idx = (extp.astype(np.int32) & 4095)
            match_valid = extp >= 4096.0
        # landmark tracks only accept depth-edge-free observations (depth at
        # occlusion-boundary corners flips between fore/background across
        # views, biasing BA). In slim mode the landmark "best descriptor"
        # stays unset (desc=None) — it has no live consumer; checkpointing
        # hydrates keyframe descriptors from the device bank instead.
        self.landmarks.add_keyframe(
            k, self.store.uv[k], self.store.xyz[k],
            self.store.obs_valid[k] & self.store.smooth[k],
            None if bow_on else self.store.desc[k],
            self.store.intensity[k], Tcw,
            match_idx, match_valid, k - 1 if k > 0 else None,
            kf_centers=self.store.centers(),
        )

        # live-export capture: pair this keyframe's own image (by timestamp,
        # from the reference ring — no copy/fetch) with its features for
        # the tracked-point overlay (Viewer.cpp:122-128 live texture) and
        # the epoch-gated occupancy keeper (MapDrawer.cpp:48-71)
        if self.live_export is not None:
            fr = self._recent_frames.get(float(h["ts"]))
            if fr is not None:
                if self._live_keeper is None:
                    from rgbdslam.viz.octomap_export import \
                        KeyframeImageKeeper

                    self._live_keeper = KeyframeImageKeeper(
                        max_frames=256, materialize=False)
                self._live_keeper.offer(k, fr[0], fr[1])
                inl = (match_valid if match_valid is not None
                       else np.zeros((N,), bool))
                self._live_overlay = (
                    fr[0], self.store.uv[k].copy(),
                    self.store.obs_valid[k].copy(),
                    np.asarray(inl, bool).copy())

        # loop-closure gate state for this keyframe (used below, and to skip
        # a local-BA solve that a pose-graph optimize + global BA would
        # immediately overwrite — ADVICE r4: the round-4 unconditional order
        # paid an extra solve dispatch on loop-closing keyframes)
        loop_gate_open = (bow_on and loop_valid is not None
                          and self.kfs_since_loop
                          >= self.cfg.loop.min_kfs_since_loop)
        likely_loop = loop_gate_open and bool(np.any(loop_valid))

        # local bundle adjustment over the sliding window (no reference
        # analog; BASELINE config 3); skipped when this keyframe carries
        # device-verified loop candidates — if the closure lands, the
        # pose-graph solve + global BA supersede the window solve anyway,
        # and if every candidate fails the host gates we only lose one
        # window polish (the next keyframe re-covers the window)
        if self.cfg.use_local_ba and not likely_loop:
            self._local_ba(k)

        # loop closure (detectLoop, Solver/PoseGraph.cpp:245-287): the
        # candidate selection AND verification already ran inside the fused
        # keyframe program (zero extra round trips — the blob carries the
        # (L,19) verified rows); here only the host gates + the solve remain
        loop_found = False
        if loop_gate_open:
            loop_found = self._close_loop_from_rows(
                k, loop_j, loop_valid, ver[C:])
            if loop_found:
                self.kfs_since_loop = 0

        # global BA polishes the pose-graph solution after a loop closure
        if self.cfg.use_global_ba and loop_found:
            self._global_ba(k)

        if (self.live_export is not None
                and (k + 1) % self.live_export[0] == 0):
            self._write_live_export()

    def _close_loop_from_rows(self, k: int, loop_j, loop_valid,
                              rows: np.ndarray) -> bool:
        """Host half of detectLoop: apply the inlier/match thresholds to the
        device-verified loop candidates, insert edges, run optimize(20)
        (Solver/PoseGraph.cpp:260-287)."""
        th = max(
            int(self.tracker.stats.mean_inliers
                * self.cfg.loop.match_fraction),
            self.cfg.ransac.min_inliers,
        )
        T_b, ninl_b, ok_b, nm_b = self._verify_decode(rows)
        self.last_loop_candidates = int(loop_valid.sum())
        closed = False
        for c in range(len(loop_j)):
            if not loop_valid[c]:
                continue
            j = int(loop_j[c])
            if self.graph.has_edge(k, j):
                continue
            if not ok_b[c] or nm_b[c] < th or ninl_b[c] < th:
                continue
            self.graph.add_edge(k, j, np.asarray(T_b[c]), kind=3)
            self.loop_detector.connect(k, j)
            closed = True
        if closed:
            import time as _time

            t0 = _time.perf_counter()
            self._optimize(self.cfg.pose_graph.opt_iters_loop)
            self.loop_solve_ms.append(
                round((_time.perf_counter() - t0) * 1e3, 2))
            self.loops_closed += 1
            # informNewBigChange (Core/Map.cpp:134-144 via
            # Solver/PoseGraph.cpp:75): the live exporter rebuilds the
            # occupancy grid when this epoch advances
            self.map_epoch += 1
        return closed

    def _write_live_export(self):
        """Periodic map/trajectory export during the run (Viewer::run
        analog, Drawer/Viewer.cpp:83-136): landmark cloud + keyframe frusta
        into map_viewer.html, top-down trajectory into trajectory.png, the
        latest keyframe's tracked-point overlay into overlay.png
        (Viewer.cpp:122-128), and an epoch-gated occupancy rebuild into
        octomap.npz (MapDrawer.cpp:48-71 big-change semantics).

        The reference renders on its own thread; here the tracking thread
        only SNAPSHOTS host state (numpy copies — immutable jax arrays are
        shared by reference) and a single worker thread does the heavy
        writes (matplotlib, PNG encode, the per-keyframe occupancy cloud
        programs). A busy worker drops the frame (freshness over
        completeness — the analog of the viewer's render poll skipping).
        All files are written atomically (tmp + rename)."""
        import time as _time

        _every, out_dir = self.live_export[:2]
        # wall-clock floor between exports (default 2 s; a third tuple
        # element overrides): file artifacts don't benefit from multiple
        # rewrites per second, and each export costs ~0.1 s of
        # GIL-shared work in the worker
        min_dt = self.live_export[2] if len(self.live_export) > 2 else 2.0
        now = _time.monotonic()
        if (not self._live_final
                and now - self._live_last_t < min_dt):
            return
        self._live_last_t = now
        K = self.store.count
        pw, inten = self.landmarks.world_points()
        _ts, cam_twc = self.tracker.camera_trajectory()
        snap = {
            "out_dir": out_dir,
            "pw": pw.copy(), "inten": inten.copy(),
            "poses_twc": (se3.inverse_np(self.store.poses_cw[:K])
                          if K else None),
            "cam_twc": cam_twc,
            "overlay": self._live_overlay,
            "epoch": self.map_epoch,
            "final": self._live_final,
            "occ": None,
        }
        self._live_overlay = None        # one write per keyframe capture
        if self._live_keeper is not None and self._live_keeper.images:
            # always ship the keeper snapshot: the worker's incremental
            # builder inserts only NEW keyframes per tick; the file write
            # happens only at epoch boundaries (+ the final export)
            snap["occ"] = (dict(self._live_keeper.images),
                           self.store.poses_cw[: self.store.max_keyframes]
                           .copy())
        self._live_enqueue(snap)

    def _live_enqueue(self, snap: dict) -> bool:
        import queue
        import threading

        if self._live_q is None:
            self._live_q = queue.Queue(maxsize=1)

            def worker():
                while True:
                    job = self._live_q.get()
                    if job is None:
                        return
                    try:
                        self._live_write_job(job)
                        self.live_exports_written += 1
                    except Exception:   # noqa: BLE001 — viz must not kill
                        pass            # the tracking thread
                    finally:
                        self._live_q.task_done()

            self._live_thread = threading.Thread(target=worker, daemon=True)
            self._live_thread.start()
        try:
            self._live_q.put_nowait(snap)
            return True
        except Exception:               # worker busy: drop this export
            self.live_exports_dropped += 1
            return False

    def live_export_flush(self, timeout: float = 60.0):
        """Block until the export worker drained (finish()/tests)."""
        if self._live_q is not None:
            self._live_q.join()

    def _live_write_job(self, snap: dict):
        import os

        from rgbdslam.viz.export import save_html_viewer

        out_dir = snap["out_dir"]
        html = os.path.join(out_dir, "map_viewer.html")
        # live writes subsample the cloud (15k points) and rasterize the
        # trajectory directly — the full-fat matplotlib/200k-point export
        # is the offline path's job (cli --plot/--export-html)
        save_html_viewer(html + ".tmp", snap["pw"], snap["inten"],
                         snap["poses_twc"], max_points=15_000)
        os.replace(html + ".tmp", html)
        if len(snap["cam_twc"]):
            from rgbdslam.viz.export import plot_trajectory_quick

            png = os.path.join(out_dir, "trajectory.png")
            plot_trajectory_quick(png + ".tmp.png", snap["cam_twc"])
            os.replace(png + ".tmp.png", png)

        if snap["overlay"] is not None:
            from matplotlib.image import imsave

            from rgbdslam.viz.export import draw_tracked_points

            g, uv, valid, inl = snap["overlay"]
            img = draw_tracked_points(np.asarray(g), uv, inl, valid)
            p = os.path.join(out_dir, "overlay.png")
            imsave(p + ".tmp.png", img.astype(np.uint8))
            os.replace(p + ".tmp.png", p)

        if snap["occ"] is not None:
            from rgbdslam.mapping.occupancy import save_grid
            from rgbdslam.viz.octomap_export import \
                IncrementalOccupancyBuilder

            if self._live_occ_builder is None:
                self._live_occ_builder = IncrementalOccupancyBuilder()
            images, poses_cw = snap["occ"]
            b = self._live_occ_builder
            grid, _changed = b.update(self.cam, images, poses_cw,
                                      snap["epoch"], self.cfg.keyframe)
            # the npz write pays a multi-MB device fetch + compression, so
            # it happens only at epoch boundaries and at shutdown — between
            # them the grid accumulates on device (the reference's GL
            # octomap is likewise only RE-RENDERED continuously; its save
            # path is never even called, Drawer/OctomapDrawer.cpp:27-36)
            if grid is not None and (b.epoch > self._live_occ_epoch
                                     or snap["final"]):
                p = os.path.join(out_dir, "octomap.npz")
                save_grid(p + ".tmp.npz", grid, extra={"epoch": b.epoch},
                          sparse_cap=2_000_000)
                os.replace(p + ".tmp.npz", p)
                self._live_occ_epoch = b.epoch

    def _relocalize(self, f: FrameFeatures):
        """LOST-state global relocalization: BoW retrieval over the keyframe
        database + batched RANSAC verification of the top candidates.

        Beyond the reference (its recover() only holds the previous pose,
        System/Tracking.cpp:195-199); the retrieval follows
        LoopDetector::obtainCandidates' scoring and the geometric check
        mirrors Tracking::correct's RansacSE3 usage
        (System/Tracking.cpp:165-193). Returns (ok, Tcw) for the tracker.
        """
        from rgbdslam.loop.bow import bow_scores, bow_vector

        ld = self.loop_detector
        if ld.words is None or ld.count < 1:
            return False, None
        if self._bow_dev is not None and self._bank is not None:
            # score against the device-resident BoW bank — re-uploading the
            # host table (up to Kmax x V f32, ~8 MB) every LOST frame pays
            # exactly the per-RPC cost the fused paths eliminate
            words, idf = self._bow_dev
            RPC.dispatches += 1
            scores = RPC.fetch(bow_scores(
                bow_vector(f.desc, f.obs_valid, words, idf), self._bank[3]
            ))[: ld.count]
        else:
            vec = bow_vector(f.desc, f.obs_valid, ld.words, ld.idf)
            RPC.dispatches += 1
            scores = RPC.fetch(
                bow_scores(vec, jnp.asarray(ld.bow_db[: ld.count]))
            )
        n_cand = min(self.cfg.reloc_max_candidates, ld.count)
        # the most recent keyframe is always a candidate: the reference
        # re-localizes against the latest distinct KF (Tracking::correct,
        # System/Tracking.cpp:165-193), and after a short sensor dropout it
        # is by far the likeliest match — BoW ranking alone can miss it
        # when the online vocabulary is still coarse
        cands = [ld.count - 1]
        cands += [int(j) for j in np.argsort(-scores)[:n_cand]
                  if int(j) != ld.count - 1]
        cands = cands[:n_cand]

        # batched match + RANSAC, reusing the proximity-verification program
        # (same padded candidate shape -> no new compile)
        T_b, ninl_b, ok_b, _nm_b = self._verify_candidates(cands, f)
        best, best_inl = -1, self.cfg.reloc_min_inliers - 1
        for c in range(len(cands)):
            if ok_b[c] and int(ninl_b[c]) > best_inl:
                best, best_inl = c, int(ninl_b[c])
        if best < 0:
            return False, None
        j = cands[best]
        # _verify_batch runs RansacSE3 with F1=candidate KF, F2=query frame,
        # so T_b = T_{query<-KF}: Tcw_query = T @ Tcw_KF
        # (Solver/SolverSE3.cpp:124-126 composition)
        Tcw = np.asarray(T_b[best]) @ self.store.poses_cw[j]
        return True, Tcw.astype(np.float32)

    # ------------------------------------------------------------------
    def _local_ba(self, k: int):
        """Window BA: optimize the last `ba_window` keyframes + their
        landmarks (first window KF fixed as gauge)."""
        import jax.numpy as jnp

        from rgbdslam.solvers.ba import local_ba

        W = self.cfg.ba_window
        if k + 1 < W:
            return
        kf_lo = k - W + 1
        problem, lm_ids, kf_ids = self.landmarks.window_problem(
            kf_lo, k, self.store.poses_cw
        )
        if len(lm_ids) < 8:
            return
        fixed = jnp.zeros((W,), bool).at[0].set(True)
        Tcw_opt, Xw_opt, _cost = local_ba(
            self.cam, problem, fixed, self.cfg.ba_iterations
        )
        RPC.dispatches += 1
        Tcw_opt = RPC.fetch(Tcw_opt)
        self.landmarks.update_from_solution(lm_ids, RPC.fetch(Xw_opt))
        self.store.poses_cw[kf_lo : k + 1] = Tcw_opt
        for i, kf in enumerate(kf_ids):
            self.graph.Twc[kf] = se3.inverse_np(Tcw_opt[i]).astype(np.float32)
        self.tracker.apply_correction(self.store.poses_cw[: k + 1],
                                      relocalize=True)

    # ------------------------------------------------------------------
    def _global_ba(self, k: int):
        """Full-map landmark-Schur bundle adjustment (beyond the reference:
        its backend is pose-graph-only, Solver/PoseGraph.cpp:350-368).

        Optimizes every keyframe pose and landmark jointly; the keyframe
        dimension is padded to a power-of-two bucket so the compiled program
        is reused as the map grows. KF 0 stays fixed as the gauge, matching
        the pose graph's vertex-0 anchor."""
        import jax.numpy as jnp

        from rgbdslam.solvers.ba import local_ba

        K = k + 1
        if K < 3:
            return
        pad_k = 4
        while pad_k < K:
            pad_k *= 2
        problem, lm_ids, kf_ids = self.landmarks.window_problem(
            0, k, self.store.poses_cw, pad_k=pad_k
        )
        if len(lm_ids) < 8:
            return
        fixed = np.zeros((pad_k,), bool)
        fixed[0] = True
        fixed[K:] = True   # padding keyframes must not move

        # joint optimization: the RANSAC-verified graph edges carry the
        # pairwise registration information (more accurate than drifting
        # landmark tracks); landmark terms add cross-view structure
        from rgbdslam.solvers.ba import BAEdges

        E = self.graph.n_edges
        Ep = 8
        while Ep < max(E, 1):
            Ep *= 2
        ea = np.zeros((Ep,), np.int32)
        eb = np.zeros((Ep,), np.int32)
        eZ = np.tile(np.eye(4, dtype=np.float32), (Ep, 1, 1))
        ew = np.zeros((Ep,), np.float32)
        ea[:E] = self.graph.e_a[:E]
        eb[:E] = self.graph.e_b[:E]
        eZ[:E] = self.graph.e_Z[:E]
        ew[:E] = self.graph.e_w[:E] * self.cfg.ba_edge_scale
        edges = BAEdges(a=jnp.asarray(ea), b=jnp.asarray(eb),
                        Z=jnp.asarray(eZ), w=jnp.asarray(ew))

        if self._mesh is not None:
            # distributed global BA: landmark blocks sharded over the mesh,
            # reduced camera system psum'd, edge factors replicated
            from rgbdslam.parallel.dist_ba import (distributed_local_ba,
                                                   shard_landmarks)

            Tcw_opt, Xw_opt, _cost = distributed_local_ba(
                self.cam, shard_landmarks(problem, self._mesh),
                jnp.asarray(fixed), self._mesh,
                self.cfg.global_ba_iterations,
                edges=edges, edge_huber=self.graph.huber_delta,
            )
        else:
            Tcw_opt, Xw_opt, _cost = local_ba(
                self.cam, problem, jnp.asarray(fixed),
                self.cfg.global_ba_iterations,
                edges=edges, edge_huber=self.graph.huber_delta,
            )
        RPC.dispatches += 1
        Tcw_opt = RPC.fetch(Tcw_opt)[:K]
        self.landmarks.update_from_solution(lm_ids, RPC.fetch(Xw_opt))
        self.store.poses_cw[:K] = Tcw_opt
        for kf in kf_ids:
            self.graph.Twc[kf] = se3.inverse_np(Tcw_opt[kf]).astype(np.float32)
        self.tracker.apply_correction(self.store.poses_cw[:K],
                                      relocalize=True)

    # ------------------------------------------------------------------
    def _optimize(self, iterations: int):
        """Global pose-graph optimization + pose write-back
        (PoseGraph::optimize + Frame::correctPose + Tracking::correct)."""
        Twc_opt = self.graph.optimize(iterations)
        K = len(Twc_opt)
        old_poses_cw = self.store.poses_cw[:K].copy()
        Tcw_opt = se3.inverse_np(np.asarray(Twc_opt)).astype(np.float32)
        # move the landmark cloud with its keyframes (Frame::correctPose
        # re-anchors landmarks after optimization, Core/Frame.cpp:437-454)
        self.landmarks.reanchor(old_poses_cw, Tcw_opt)
        self.store.set_poses(Tcw_opt)
        self.tracker.apply_correction(Tcw_opt)

    # ------------------------------------------------------------------
    def finish(self):
        """Drain + final optimization (PoseGraph::shutdown,
        Solver/PoseGraph.cpp:407-418)."""
        if self.graph.n_vertices > 5:
            self._optimize(self.cfg.pose_graph.opt_iters_default)
            if self.cfg.use_global_ba:
                self._global_ba(self.graph.n_vertices - 1)
        if self.live_export is not None:
            # final guaranteed export (the shutdown render): drain the
            # worker so the queue is free, snapshot the final state (incl.
            # any pending epoch-gated occupancy rebuild), drain again
            self.live_export_flush()
            self._live_final = True
            self._write_live_export()
            self._live_final = False
            self.live_export_flush()

    def camera_trajectory(self):
        return self.tracker.camera_trajectory()

    def keyframe_trajectory(self):
        return self.tracker.keyframe_trajectory()
