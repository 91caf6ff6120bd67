"""Covisibility graph tests."""

import numpy as np

from rgbdslam.mapping.covisibility import (
    best_covisibles,
    connections,
    covisibility_matrix,
    spanning_tree,
)
from rgbdslam.mapping.landmarks import LandmarkStore


def build_store(obs_lists):
    """obs_lists: per-landmark list of observing keyframes."""
    store = LandmarkStore(max_landmarks=64, max_obs=8, num_features=4)
    T = np.eye(4, dtype=np.float32)
    xyz = np.array([[0.0, 0.0, 2.0]], np.float32)
    for kfs in obs_lists:
        l = store._new_landmark(np.zeros(3, np.float32), np.zeros(8, np.uint32), 0.0)
        for kf in kfs:
            store._add_obs(l, kf, np.zeros(2, np.float32), 2.0)
    return store


def test_covisibility_counts():
    # 20 landmarks seen by KFs {0,1}; 5 by {1,2}; 3 by {0,2}
    obs = [[0, 1]] * 20 + [[1, 2]] * 5 + [[0, 2]] * 3
    store = build_store(obs)
    co = covisibility_matrix(store, 3)
    assert co[0, 1] == 20 and co[1, 0] == 20
    assert co[1, 2] == 5
    assert co[0, 2] == 3
    assert co[0, 0] == 0


def test_connections_threshold_and_fallback():
    obs = [[0, 1]] * 20 + [[1, 2]] * 5
    store = build_store(obs)
    co = covisibility_matrix(store, 3)
    conns1 = connections(co, 1)        # 20 with KF0 (>=15), 5 with KF2 (<15)
    assert conns1[0] == (0, 20)
    assert all(kf != 2 for kf, _ in conns1)
    # KF2's best (5 < threshold) kept as fallback
    conns2 = connections(co, 2)
    assert conns2 == [(1, 5)]


def test_best_covisibles_ordering():
    obs = [[0, 1]] * 20 + [[1, 2]] * 30 + [[1, 3]] * 10
    store = build_store(obs)
    co = covisibility_matrix(store, 4)
    top = best_covisibles(co, 1, 3)
    assert top == [2, 0, 3]


def test_spanning_tree():
    obs = [[0, 1]] * 20 + [[1, 2]] * 18 + [[0, 3]] * 2
    store = build_store(obs)
    co = covisibility_matrix(store, 4)
    tree = spanning_tree(co)
    assert tree[1] == 0
    assert tree[2] == 1
    assert tree[3] == 0   # weak but best among earlier
