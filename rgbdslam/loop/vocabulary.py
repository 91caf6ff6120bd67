"""Vocabulary persistence + offline training.

The reference ships a pre-trained DBoW3 vocabulary file loaded at startup
(`voc_TUM_FAST_BRIEF.yml.gz`, main.cpp:15,32 — not even included in the
repo). Equivalent workflow here: train a binary codebook offline over a
dataset's descriptors (tools-style entry point below), save it as npz, and
hand it to the LoopDetector so runs skip on-the-fly training.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rgbdslam.ops.backend import PLATFORMS, select_platform

#: shipped vocabulary artifacts by descriptor family (the reference's
#: voc_TUM_FAST_BRIEF.yml.gz analog, main.cpp:15 — trained offline over
#: synthetic worlds, tools: this module's CLI)
_SHIPPED = {
    "svo_fast": "voc_synth_fast_brief.npz",
    "fast": "voc_synth_fast_brief.npz",
    "brief": "voc_synth_fast_brief.npz",
    "orb": "voc_synth_orb.npz",
    "orb2": "voc_synth_orb.npz",
}


def shipped_vocabulary(detector: str) -> Optional[str]:
    """Path of the shipped vocabulary matching a detector's descriptor
    family, or None if no artifact fits (float families train online)."""
    import os

    name = _SHIPPED.get(detector)
    if name is None:
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", name)
    return path if os.path.exists(path) else None


def save_vocabulary(path: str, words, idf) -> None:
    np.savez_compressed(path, words=np.asarray(words), idf=np.asarray(idf))


def load_vocabulary(path: str):
    import jax.numpy as jnp

    d = np.load(path)
    return jnp.asarray(d["words"]), jnp.asarray(d["idf"])


def collect_descriptors(dataset, cam, extractor_cfg, frame_stride: int = 5,
                        max_frames: int = 40, detector: str = "svo_fast"):
    """Run the extractor over a dataset; returns host (desc, valid)."""
    import jax
    import jax.numpy as jnp

    from rgbdslam.frontend.extractor import Extractor

    ex = Extractor(cam, extractor_cfg, detector=detector)
    descs, valids = [], []
    n = min(len(dataset), max_frames * frame_stride)
    for i in range(0, n, frame_stride):
        ts, gray, depth = dataset.grab(i)
        f = ex(jnp.asarray(gray), jnp.asarray(depth))
        d, v = jax.device_get((f.desc, f.valid))
        descs.append(d)
        valids.append(v)
    return np.concatenate(descs), np.concatenate(valids)


def train_vocabulary_from_dataset(
    dataset,
    cam,
    extractor_cfg,
    vocab_size: int = 1024,
    iters: int = 8,
    frame_stride: int = 5,
    max_frames: int = 40,
    seed: int = 0,
) -> tuple:
    """Run the extractor over a dataset and k-majority-train a codebook
    (the DBoW3 offline-vocabulary workflow)."""
    import jax.numpy as jnp

    from rgbdslam.loop.codebook import train_codebook

    desc, valid = collect_descriptors(dataset, cam, extractor_cfg,
                                      frame_stride, max_frames)
    return train_codebook(jnp.asarray(desc), jnp.asarray(valid), vocab_size, iters)


def main(argv=None) -> int:
    """CLI: python -m rgbdslam.loop.vocabulary --dataset ... --out voc.npz"""
    import argparse

    ap = argparse.ArgumentParser(description="train a loop-closure vocabulary")
    ap.add_argument("--dataset", required=True, nargs="+",
                    help="one or more datasets; descriptors are pooled "
                         "(synthetic specs accept :trajectory:seed:noise "
                         "suffixes, e.g. synthetic:orbit:3:noise)")
    ap.add_argument("--kind", default="TUM")
    ap.add_argument("--out", required=True)
    ap.add_argument("--vocab-size", type=int, default=1024)
    ap.add_argument("--detector", default="svo_fast",
                    help="extractor variant whose descriptors to train on")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--platform", default="auto", choices=PLATFORMS)
    args = ap.parse_args(argv)
    select_platform(args.platform)

    import jax.numpy as jnp

    from rgbdslam.config import ExtractorConfig
    from rgbdslam.io.datasets import open_dataset
    from rgbdslam.loop.codebook import train_codebook

    descs, valids = [], []
    for spec in args.dataset:
        if spec.startswith("synthetic"):
            parts = spec.split(":")
            traj = parts[1] if len(parts) > 1 else "orbit"
            seed = int(parts[2]) if len(parts) > 2 else 0
            noise = len(parts) > 3 and parts[3] == "noise"
            from rgbdslam.io.synthetic import SyntheticDataset

            ds = SyntheticDataset(n_frames=args.frames * args.stride,
                                  trajectory=traj, seed=seed, noise=noise)
        else:
            ds = open_dataset(spec, kind=args.kind)
        d, v = collect_descriptors(ds, ds.cam, ExtractorConfig(),
                                   args.stride, args.frames,
                                   detector=args.detector)
        descs.append(d)
        valids.append(v)
        print(f"{spec}: {int(v.sum())} descriptors")
    desc = np.concatenate(descs)
    valid = np.concatenate(valids)
    words, idf = train_codebook(jnp.asarray(desc), jnp.asarray(valid),
                                args.vocab_size, 8)
    save_vocabulary(args.out, words, idf)
    print(f"saved {args.vocab_size}-word vocabulary to {args.out} "
          f"({int(valid.sum())} training descriptors)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
