"""Cross-session map merging via a Sim(3) pose graph.

The live consumer of sim3/optimize_sim3_graph (VERDICT r2 #9): two SLAM
sessions over the same space are merged into one metric map. The reference
carries Sim3 conversions but never uses them (System/Converter.cpp — g2o's
Sim3 types, vestigial); here Sim(3) earns its keep on a real RGB-D failure
mode: *depth-factor miscalibration*. Each dataset hardcodes a depth scale
(TUM freiburg2 is 5208, not 5000 — IO/DatasetTUM.cpp:61-89); a session
recorded with the wrong factor produces a map uniformly mis-scaled by
alpha. A rigid (SE3) merge cannot reconcile the overlap; a Sim(3) merge
recovers alpha as the second session's vertex scale.

Pipeline (mirrors the loop-closure path, cross-session):
1. candidate keyframe pairs by BoW score between the sessions' databases
   (both sessions must share a vocabulary — the shipped-artifact workflow);
2. geometric verification: descriptor matching + batched Sim(3) RANSAC
   (scale-aware Umeyama hypotheses, euclidean inlier test);
3. one joint Sim(3) pose graph: both sessions' existing edges (SE3 lifted
   at scale 1 — self-consistent within a session whatever its scale) + the
   verified inter-session Sim(3) edges; session A's vertex 0 is the gauge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.frontend.matcher import match_descriptors
from rgbdslam.geometry import sim3
from rgbdslam.solvers.kabsch import weighted_similarity_transform
from rgbdslam.solvers.pose_graph import PoseGraphEdges, optimize_sim3_graph


def sim3_ransac(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    num_hypotheses: int = 128,
    sample_size: int = 4,
    inlier_m: float = 0.08,
    refine_iters: int = 3,
):
    """Batched Sim(3) RANSAC: find S21 with p2 ~= s R p1 + t.

    Same architecture as ransac_se3 (batched hypotheses + masked refinement,
    SURVEY.md §7 layer 5) with the scale-aware Umeyama model and a euclidean
    inlier test (scale makes the Mahalanobis whitening of the SE3 solver
    ill-posed until s is known). Returns (S21 (4,4), n_inliers, success).
    """
    N = p1.shape[0]
    nv = jnp.maximum(jnp.sum(valid), 1)
    probs = valid.astype(jnp.float32) / nv
    k_draw, _ = jax.random.split(key)
    idx = jax.random.choice(
        k_draw, N, shape=(num_hypotheses, sample_size), p=probs)
    w1 = jnp.ones((num_hypotheses, sample_size), jnp.float32)
    S_h = weighted_similarity_transform(p1[idx], p2[idx], w1)   # (H, 4, 4)

    def inliers_of(S):
        pred = p1 @ jnp.swapaxes(S[..., :3, :3], -1, -2) + S[..., None, :3, 3]
        err = jnp.linalg.norm(pred - p2, axis=-1)
        return (err < inlier_m) & valid

    inl = jax.vmap(inliers_of)(S_h)                              # (H, N)
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)
    S = S_h[best]

    def refine(S, _):
        w = inliers_of(S).astype(jnp.float32)
        S_new = weighted_similarity_transform(p1, p2, w)
        return S_new, None

    S, _ = jax.lax.scan(refine, S, None, length=refine_iters)
    n_inl = jnp.sum(inliers_of(S))
    return S, n_inl, n_inl >= sample_size


@dataclass
class MergeResult:
    Twc: np.ndarray          # (Ka+Kb, 4, 4) merged metric SE(3) poses
    scales: np.ndarray       # (Ka+Kb,) per-vertex Sim(3) scale (A ~= 1;
    #                          B ~= 1/alpha for a session mis-scaled by alpha)
    pairs: List[Tuple[int, int]]   # verified (kf_a, kf_b) anchor pairs
    inliers: List[int]


def merge_maps(
    sys_a,
    sys_b,
    max_pairs: int = 3,
    min_inliers: int = 20,
    iterations: int = 12,
    information: float = 100.0,
    seed: int = 0,
) -> MergeResult:
    """Merge session B's map into session A's metric frame.

    Both systems must have BoW databases of the same width (shared
    vocabulary). Raises ValueError when no inter-session pair verifies.
    """
    for s in (sys_a, sys_b):
        if hasattr(s, "hydrate_host"):
            s.hydrate_host()     # slim-blob mode defers host desc/BoW rows
    Ka, Kb = sys_a.store.count, sys_b.store.count
    dba = sys_a.loop_detector.bow_db[:Ka]
    dbb = sys_b.loop_detector.bow_db[:Kb]
    if dba.shape[1] != dbb.shape[1]:
        raise ValueError("sessions use different vocabularies")

    # 1. cross-session BoW scores (L1 similarity, loop/bow.py convention)
    scores = 1.0 - 0.5 * np.abs(dba[:, None, :] - dbb[None, :, :]).sum(-1)
    order = np.argsort(-scores, axis=None)
    pairs: List[Tuple[int, int]] = []
    used_a, used_b = set(), set()
    for flat in order:
        ia, ib = int(flat // Kb), int(flat % Kb)
        if ia in used_a or ib in used_b:
            continue
        pairs.append((ia, ib))
        used_a.add(ia)
        used_b.add(ib)
        if len(pairs) >= max_pairs:
            break

    # 2. geometric verification with Sim(3) RANSAC
    key = jax.random.PRNGKey(seed)
    verified: List[Tuple[int, int, np.ndarray]] = []
    inl_counts: List[int] = []
    for ka, kb in pairs:
        da, xa, va = sys_a.store.features_of(ka)
        db, xb, vb = sys_b.store.features_of(kb)
        m = match_descriptors(jnp.asarray(da), jnp.asarray(va),
                              jnp.asarray(db), jnp.asarray(vb))
        mvalid = m.valid & jnp.asarray(vb)[m.idx2]
        key, sub = jax.random.split(key)
        S21, n_inl, ok = sim3_ransac(
            jnp.asarray(xa), jnp.asarray(xb)[m.idx2], mvalid, sub)
        n_inl = int(n_inl)
        if bool(ok) and n_inl >= min_inliers:
            verified.append((ka, kb, np.asarray(S21)))
            inl_counts.append(n_inl)
    if not verified:
        raise ValueError("no inter-session pair verified")

    # 3. joint Sim(3) graph. Vertices: A's KFs then B's (index + Ka).
    #    Inter-session measurement for edge (va=ka, vb=Ka+kb) must map
    #    vb-camera coords into va-camera coords (the SE3 graph's Z = T_{a<-b}
    #    convention): Z = S21^{-1} since RANSAC fit p_b ~= S21 p_a.
    K = Ka + Kb
    Swc = np.zeros((K, 4, 4), np.float32)
    for i in range(Ka):
        Swc[i] = np.linalg.inv(sys_a.store.poses_cw[i])
    ka0, kb0, S0 = verified[0]
    Z0 = np.asarray(sim3.inverse(jnp.asarray(S0)))
    # S_AB carries B-frame coords into A's metric world; seeds every B vertex
    S_AB = (np.linalg.inv(sys_a.store.poses_cw[ka0]) @ Z0
            @ sys_b.store.poses_cw[kb0]).astype(np.float32)
    for j in range(Kb):
        Swc[Ka + j] = S_AB @ np.linalg.inv(sys_b.store.poses_cw[j])

    ea, eb, eZ, ew = [], [], [], []
    for g, off in ((sys_a.graph, 0), (sys_b.graph, Ka)):
        for e in range(g.n_edges):
            ea.append(off + int(g.e_a[e]))
            eb.append(off + int(g.e_b[e]))
            eZ.append(g.e_Z[e])          # SE3 lifted to Sim3 at scale 1
            ew.append(float(g.e_w[e]))
    for (ka, kb, S21), n_inl in zip(verified, inl_counts):
        ea.append(ka)
        eb.append(Ka + kb)
        eZ.append(np.asarray(sim3.inverse(jnp.asarray(S21)),
                             dtype=np.float32))
        ew.append(information)

    E = len(ea)
    Kp, Ep = 8, 8
    while Kp < K:
        Kp *= 2
    while Ep < E:
        Ep *= 2
    Swc_p = np.tile(np.eye(4, dtype=np.float32), (Kp, 1, 1))
    Swc_p[:K] = Swc
    edges = PoseGraphEdges(
        a=jnp.asarray(np.pad(np.asarray(ea, np.int32), (0, Ep - E))),
        b=jnp.asarray(np.pad(np.asarray(eb, np.int32), (0, Ep - E))),
        Z=jnp.asarray(np.concatenate(
            [np.stack(eZ),
             np.tile(np.eye(4, dtype=np.float32), (Ep - E, 1, 1))])),
        weight=jnp.asarray(np.pad(np.asarray(ew, np.float32), (0, Ep - E))),
    )
    fixed = np.zeros((Kp,), bool)
    fixed[0] = True
    fixed[K:] = True
    S_opt, _cost = optimize_sim3_graph(
        jnp.asarray(Swc_p), edges, jnp.asarray(fixed), iterations)
    S_opt = np.asarray(S_opt)[:K]

    scales = np.asarray(sim3.scale_of(jnp.asarray(S_opt)))
    Twc = S_opt.copy()
    Twc[:, :3, :3] /= scales[:, None, None]
    return MergeResult(Twc=Twc, scales=scales,
                       pairs=[(ka, kb) for ka, kb, _ in verified],
                       inliers=inl_counts)
