"""Render a tiny TUM-format RGB-D dataset from the synthetic renderer.

Produces rgb/, depth/ (16-bit, factor 5000), associations.txt and
groundtruth.txt under --out, with freiburg3 intrinsics inferred from the
directory name (IO/DatasetTUM.cpp:61-89 semantics). Used by the verify
recipe's disk-dataset surface (no real TUM data is downloadable in this
environment).

  python tools/make_fake_tum.py [--out DIR] [--frames N]
"""
import argparse
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out",
                    default="/tmp/fake_tum/rgbd_dataset_freiburg3_tiny")
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import cv2
    from scipy.spatial.transform import Rotation

    from rgbdslam.geometry.camera import Camera
    from rgbdslam.io.synthetic import SyntheticDataset

    out = args.out
    os.makedirs(out + "/rgb", exist_ok=True)
    os.makedirs(out + "/depth", exist_ok=True)
    # freiburg3 intrinsics (IO/DatasetTUM.cpp freiburg3; factor 5000)
    cam = Camera(535.4, 539.2, 320.1, 247.6, width=640, height=480)
    ds = SyntheticDataset(n_frames=args.frames, cam=cam, trajectory="sweep")
    assoc, gt = [], []
    for i in range(len(ds)):
        ts, gray, depth = ds.grab(i)
        g = np.asarray(gray).astype(np.uint8)
        d = np.clip(np.asarray(depth) * 5000.0, 0, 65535).astype(np.uint16)
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        cv2.imwrite(os.path.join(out, rp), g)
        cv2.imwrite(os.path.join(out, dp), d)
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        gt.append((ts, np.asarray(ds.poses_twc[i])))
    with open(os.path.join(out, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(out, "groundtruth.txt"), "w") as f:
        for ts, Twc in gt:
            t = Twc[:3, 3]
            qx, qy, qz, qw = Rotation.from_matrix(Twc[:3, :3]).as_quat()
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")
    print("wrote", out, len(ds), "frames")


if __name__ == "__main__":
    main()
