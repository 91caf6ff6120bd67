"""Map checkpoint/resume: save/load the full SLAM state as npz.

First-class capability the reference only stubs: Map::save/load are declared
but never defined (Core/Map.h:47-48, SURVEY.md §5.4). Serializes the keyframe
store, pose graph (vertices + edges), trajectory bookkeeping, and the loop
codebook, so a session can resume tracking or re-optimize offline.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def save_map(path: str, system) -> None:
    """Serialize a SlamSystem's persistent state to one .npz file."""
    if hasattr(system, "hydrate_host"):
        # slim-blob mode defers descriptor/BoW rows on the device bank;
        # checkpointing is the consumer that needs them on host
        system.hydrate_host()
    store = system.store
    graph = system.graph
    det = system.loop_detector
    K = store.count
    E = graph.n_edges
    tracker = system.tracker

    meta = {
        "version": 1,
        "num_keyframes": K,
        "num_edges": E,
        "kfs_since_loop": system.kfs_since_loop,
        "loops_closed": system.loops_closed,
        "mean_inliers": tracker.stats.mean_inliers,
        "acum_inliers": tracker.stats.acum_inliers,
        "frames": tracker.stats.frames,
    }
    arrays = dict(
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        kf_desc=store.desc[:K],
        kf_xyz=store.xyz[:K],
        kf_obs_valid=store.obs_valid[:K],
        kf_uv=store.uv[:K],
        kf_intensity=store.intensity[:K],
        kf_poses_cw=store.poses_cw[:K],
        kf_timestamps=store.timestamps[:K],
        edge_a=graph.e_a[:E],
        edge_b=graph.e_b[:E],
        edge_Z=graph.e_Z[:E],
        edge_w=graph.e_w[:E],
        traj_ts=np.asarray([f.timestamp for f in tracker.trajectory]),
        traj_Tcr=np.stack([f.Tcr for f in tracker.trajectory])
        if tracker.trajectory else np.zeros((0, 4, 4), np.float32),
        traj_ref=np.asarray([f.ref_kf_index for f in tracker.trajectory],
                            dtype=np.int32),
        connections=np.frombuffer(
            json.dumps([sorted(c) for c in det._connections]).encode(),
            dtype=np.uint8,
        ),
    )
    if det.words is not None:
        arrays["vocab_words"] = np.asarray(det.words)
        arrays["vocab_idf"] = np.asarray(det.idf)
        arrays["bow_db"] = det.bow_db[:K]
    np.savez_compressed(path, **arrays)


def load_map(path: str, system) -> None:
    """Restore state saved by save_map into a fresh SlamSystem (same config)."""
    import jax.numpy as jnp

    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    K = meta["num_keyframes"]
    E = meta["num_edges"]

    store = system.store
    store.desc[:K] = data["kf_desc"]
    store.xyz[:K] = data["kf_xyz"]
    store.obs_valid[:K] = data["kf_obs_valid"]
    store.uv[:K] = data["kf_uv"]
    store.intensity[:K] = data["kf_intensity"]
    store.poses_cw[:K] = data["kf_poses_cw"]
    store.timestamps[:K] = data["kf_timestamps"]
    store.count = K

    graph = system.graph
    graph.e_a[:E] = data["edge_a"]
    graph.e_b[:E] = data["edge_b"]
    graph.e_Z[:E] = data["edge_Z"]
    graph.e_w[:E] = data["edge_w"]
    graph.n_edges = E
    graph.n_vertices = K
    for k in range(K):
        graph.Twc[k] = np.linalg.inv(store.poses_cw[k])
    graph._edge_keys = {
        (int(a), int(b)) for a, b in zip(graph.e_a[:E], graph.e_b[:E])
    }

    det = system.loop_detector
    conns = json.loads(bytes(data["connections"]).decode())
    det._connections = [set(c) for c in conns]
    det.count = K
    det._pending = [
        (store.desc[k].copy(), store.obs_valid[k].copy()) for k in range(K)
    ]
    if "vocab_words" in data:
        det.words = jnp.asarray(data["vocab_words"])
        det.idf = jnp.asarray(data["vocab_idf"])
        det.bow_db[:K] = data["bow_db"]

    system.kfs_since_loop = meta["kfs_since_loop"]
    system.loops_closed = meta["loops_closed"]

    tracker = system.tracker
    tracker.stats.acum_inliers = meta["acum_inliers"]
    tracker.stats.frames = meta["frames"]
    from rgbdslam.slam.tracking import TrackedFrame

    tracker.trajectory = [
        TrackedFrame(float(ts), np.eye(4, dtype=np.float32), Tcr, int(ref))
        for ts, Tcr, ref in zip(data["traj_ts"], data["traj_Tcr"], data["traj_ref"])
    ]
    # host keyframe registry mirrors the store (features omitted from the
    # tracker side; the store is authoritative after resume)
    tracker.keyframes = [
        (float(store.timestamps[k]), None, store.poses_cw[k].copy())
        for k in range(K)
    ]
    if K:
        tracker.last_kf_Tcw = store.poses_cw[K - 1].copy()

    # the backend verifies against the DEVICE bank, not the host store —
    # push the restored keyframes back onto the device
    if hasattr(system, "rebuild_bank_from_store"):
        system.rebuild_bank_from_store()
