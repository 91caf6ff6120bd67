"""Covisibility graph over keyframes from shared landmark observations.

Array-program Core/GraphNode.{h,cpp}: the reference ships an ORB-SLAM2-style
covisibility node (weighted connections when two keyframes share >= 15
landmark observations, ordered covisibles, spanning tree) but never
instantiates it (Core/GraphNode.cpp is compiled yet dead, SURVEY.md §2.2).
Here the graph is *derived data*: one call computes the full K x K
co-observation count matrix from the landmark store's observation table — a
segment-count matmul instead of per-frame mutex-guarded map updates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from rgbdslam.mapping.landmarks import LandmarkStore

COVIS_THRESHOLD = 15  # Core/GraphNode.h:65 (weight threshold)


def covisibility_matrix(store: LandmarkStore, num_keyframes: int) -> np.ndarray:
    """(K, K) matrix: entry [i, j] = number of landmarks observed by both."""
    K = num_keyframes
    L = store.count
    if L == 0 or K == 0:
        return np.zeros((K, K), np.int32)
    # incidence matrix: landmark x keyframe
    inc = np.zeros((L, K), np.int8)
    kf = store.obs_kf[:L]
    ok = store.obs_valid[:L] & (kf < K)
    lm_idx, obs_idx = np.nonzero(ok)
    inc[lm_idx, kf[lm_idx, obs_idx]] = 1
    co = inc.T.astype(np.int32) @ inc.astype(np.int32)
    np.fill_diagonal(co, 0)
    return co


def connections(co: np.ndarray, k: int,
                threshold: int = COVIS_THRESHOLD) -> List[Tuple[int, int]]:
    """Weighted connections of keyframe k: [(kf, weight)] sorted by weight
    (GraphNode::updateConnections / orderedConnections semantics,
    Core/GraphNode.cpp:58-194)."""
    w = co[k]
    idx = np.nonzero(w >= threshold)[0]
    if len(idx) == 0 and w.max(initial=0) > 0:
        # the reference keeps at least the best partner when none clears the
        # threshold (Core/GraphNode.cpp:101-106)
        idx = np.array([int(w.argmax())])
    order = np.argsort(-w[idx])
    return [(int(i), int(w[i])) for i in idx[order]]


def best_covisibles(co: np.ndarray, k: int, n: int) -> List[int]:
    """Top-n covisible keyframes (GraphNode::covisiblesByWeight analog)."""
    w = co[k]
    idx = np.argsort(-w)
    return [int(i) for i in idx[:n] if w[i] > 0]


def spanning_tree(co: np.ndarray) -> Dict[int, int]:
    """Maximum-covisibility spanning tree: child -> parent, rooted at KF 0
    (GraphNode parent/children, Core/GraphNode.cpp:206-251). Each keyframe
    attaches to its strongest covisible among already-attached (earlier)
    keyframes, falling back to the previous keyframe."""
    K = co.shape[0]
    parent: Dict[int, int] = {}
    for k in range(1, K):
        w = co[k, :k]
        if len(w) and w.max(initial=0) > 0:
            parent[k] = int(w.argmax())
        else:
            parent[k] = k - 1
    return parent
