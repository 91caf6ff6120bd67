"""TUM-format trajectory writing/reading.

Format: `timestamp tx ty tz qx qy qz qw` per line, where (t, q) is the
camera-to-world transform Twc (reference: Core/Frame.cpp:20-30 writes the KF
pose inverse; System/Tracking.cpp:286-317 writes camera poses the same way).
"""

from __future__ import annotations

import io
from typing import List, Sequence, Tuple

import numpy as np

from rgbdslam.geometry import se3

import jax.numpy as jnp


def twc_to_line(timestamp: float, Twc: np.ndarray) -> str:
    q = np.asarray(se3.quat_from_rotation(jnp.asarray(Twc[:3, :3], dtype=jnp.float32)))
    t = Twc[:3, 3]
    return (
        f"{timestamp:.6f} "
        f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
        f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}"
    )


def save_tum(path: str, timestamps: Sequence[float], poses_twc: Sequence[np.ndarray]) -> None:
    """Write a TUM-format trajectory (Twc per timestamp)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_twc):
            f.write(twc_to_line(float(ts), np.asarray(T)) + "\n")


def load_tum(path_or_file) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM-format trajectory (also ground-truth files with '#' comments).

    Returns (timestamps [N], poses_twc [N,4,4]).
    """
    if isinstance(path_or_file, (str, bytes)):
        f = open(path_or_file, "r")
        close = True
    else:
        f = path_or_file
        close = False
    try:
        ts: List[float] = []
        mats: List[np.ndarray] = []
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            t = np.array(vals[1:4], dtype=np.float32)
            q = np.array(vals[4:8], dtype=np.float32)  # (x, y, z, w)
            R = np.asarray(se3.rotation_from_quat(jnp.asarray(q)))
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = t
            ts.append(vals[0])
            mats.append(T)
        return np.asarray(ts, dtype=np.float64), np.stack(mats) if mats else np.zeros((0, 4, 4), np.float32)
    finally:
        if close:
            f.close()


def dumps_tum(timestamps: Sequence[float], poses_twc: Sequence[np.ndarray]) -> str:
    buf = io.StringIO()
    for ts, T in zip(timestamps, poses_twc):
        buf.write(twc_to_line(float(ts), np.asarray(T)) + "\n")
    return buf.getvalue()
