"""Frontend smoke test on real Kinect imagery (TUM fr1_desk content).

The reference ships two result screenshots whose underlying pixels are real
TUM fr1 desk frames (/root/reference/Tests/im1.png — README.md:1-5 result
images). With zero egress there is no full TUM sequence on this machine
(BASELINE.md), but that photographic texture is real sensor content — enough
to validate the detector/descriptor/matcher stack on real imagery rather
than only the synthetic renderer:

- the detector fills a healthy share of the keypoint budget on real texture;
- descriptors are discriminative on real texture: matching the frame against
  a translated copy recovers the known shift for most surviving matches
  (2-NN ratio + mutual check, Features/Matcher.cpp:113-150 semantics).

Skipped when the reference tree is absent (the image is read at runtime,
never copied into this repo).
"""

import os

import numpy as np
import pytest

REF_IMG = "/root/reference/Tests/im1.png"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_IMG), reason="reference test image not present"
)


@pytest.fixture(scope="module")
def real_gray():
    from PIL import Image

    arr = np.asarray(Image.open(REF_IMG).convert("L"), np.float32)
    h, w = arr.shape
    out = np.zeros((480, 640), np.float32)
    out[: min(h, 480), : min(w, 640)] = arr[:480, :640]
    return out


def _features(gray_np):
    import jax.numpy as jnp

    from rgbdslam.config import SlamConfig
    from rgbdslam.frontend.frame import build_frame_features
    from rgbdslam.geometry.camera import SYNTHETIC

    depth = jnp.full(gray_np.shape, 1.5, jnp.float32)
    return build_frame_features(
        SYNTHETIC, jnp.asarray(gray_np), depth, SlamConfig().extractor
    )


def test_detector_fills_budget_on_real_texture(real_gray):
    f = _features(real_gray)
    n = int(np.sum(np.asarray(f.valid)))
    # a cluttered desk scene should fill a large share of the 1000-slot
    # budget (Features/Extractor.cpp:21); synthetic-world thresholds must
    # not have been tuned so hot that real texture starves
    assert n >= 400, f"only {n} keypoints on a real desk scene"


def test_matching_recovers_translation_on_real_texture(real_gray):
    from rgbdslam.frontend.matcher import match_frames

    dx, dy = 7, 4
    shifted = np.roll(np.roll(real_gray, dy, axis=0), dx, axis=1)
    f1 = _features(real_gray)
    f2 = _features(shifted)
    m = match_frames(f1, f2, ratio=0.8)

    valid = np.asarray(m.valid)
    assert valid.sum() >= 150, f"only {valid.sum()} matches on real texture"

    uv1 = np.asarray(f1.uv)[valid]
    uv2 = np.asarray(f2.uv)[np.asarray(m.idx2)[valid]]
    d = uv2 - uv1
    ok = (np.abs(d[:, 0] - dx) <= 1.5) & (np.abs(d[:, 1] - dy) <= 1.5)
    # descriptors must be discriminative enough that most surviving matches
    # are the true correspondence, not repeated-texture aliases
    assert ok.mean() > 0.7, f"only {ok.mean():.2%} of matches recover the shift"
