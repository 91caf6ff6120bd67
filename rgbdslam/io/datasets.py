"""TUM / ICL-NUIM / CORBS dataset readers (IO/Dataset* equivalent).

Parses `associations.txt` (timestamp rgb_ts rgb_path ts depth_path — the same
format the reference consumes, IO/DatasetTUM.cpp:39-55) and infers the camera
from the directory name (IO/DatasetTUM.cpp:61-89's freiburg1/2/3 switch).
Images load via cv2 (preferred) or PIL.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from rgbdslam.geometry.camera import (
    CORBS,
    Camera,
    ICL_NUIM,
    TUM_FR1,
    TUM_FR2,
    TUM_FR3,
)

def _imread(path: str, gray: bool) -> np.ndarray:
    """Image as float32 via cv2, else PIL; both are optional and imported
    only when a disk dataset is read."""
    try:
        import cv2  # type: ignore
    except ImportError:
        from PIL import Image  # type: ignore

        img = Image.open(path)
        return np.asarray(img.convert("L") if gray else img, dtype=np.float32)
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                     else cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _load_gray(path: str) -> np.ndarray:
    return _imread(path, gray=True)


def _load_depth_raw(path: str) -> np.ndarray:
    return _imread(path, gray=False)


def detect_tum_camera(base_dir: str) -> Camera:
    """freiburg1/2/3 intrinsics switch (IO/DatasetTUM.cpp:61-89)."""
    idx = base_dir.find("freiburg")
    if idx < 0:
        return TUM_FR3
    c = base_dir[idx + 8 : idx + 9]
    return {"1": TUM_FR1, "2": TUM_FR2, "3": TUM_FR3}.get(c, TUM_FR3)


def parse_associations(path: str) -> Tuple[List[float], List[str], List[str]]:
    """`timestamp rgb ts depth` association file (IO/DatasetTUM.cpp:39-55)."""
    ts, rgb, depth = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgb.append(parts[1])
            depth.append(parts[3])
    return ts, rgb, depth


class RGBDDataset:
    """Disk-backed RGB-D dataset with the grab(i) interface of SyntheticDataset.

    kind: 'TUM' | 'ICL' | 'CORBS' (IO/Dataset.h enum + factory,
    IO/Dataset.cpp:29-41)."""

    def __init__(self, base_dir: str, kind: str = "TUM", camera: Optional[Camera] = None):
        self.base_dir = base_dir
        self.kind = kind
        assoc = os.path.join(base_dir, "associations.txt")
        self.timestamps, self.rgb_files, self.depth_files = parse_associations(assoc)
        if camera is not None:
            self.cam = camera
        elif kind == "TUM":
            self.cam = detect_tum_camera(base_dir)
        elif kind == "ICL":
            self.cam = ICL_NUIM
        elif kind == "CORBS":
            self.cam = CORBS
        else:
            raise ValueError(f"unknown dataset kind {kind!r}")

    def __len__(self) -> int:
        return len(self.timestamps)

    def grab(self, i: int):
        """Returns (timestamp, gray [H,W] f32 0..255, depth [H,W] f32 meters).

        Depth scaling by 1/depth_factor mirrors Core/Frame.cpp:48.
        """
        gray = _load_gray(os.path.join(self.base_dir, self.rgb_files[i]))
        raw = _load_depth_raw(os.path.join(self.base_dir, self.depth_files[i]))
        depth = raw / self.cam.depth_factor
        return self.timestamps[i], gray, depth

    def ground_truth_path(self) -> Optional[str]:
        p = os.path.join(self.base_dir, "groundtruth.txt")
        return p if os.path.exists(p) else None


def open_dataset(path_or_kind: str, **kwargs):
    """Factory: 'synthetic' / 'synthetic:sweep' or a directory path."""
    if path_or_kind.startswith("synthetic"):
        from rgbdslam.io.synthetic import SyntheticDataset

        traj = path_or_kind.split(":", 1)[1] if ":" in path_or_kind else "orbit"
        return SyntheticDataset(trajectory=traj, **kwargs)
    kind = kwargs.pop("kind", "TUM")
    return RGBDDataset(path_or_kind, kind=kind, **kwargs)
