"""Detector/descriptor family breadth (Features/Extractor.h:13-26 parity):
STAR/DoG/Hessian responses, BRISK/FREAK/LATCH binary patterns, SIFT-class
float descriptors with the L2 matcher path."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.config import ExtractorConfig
from rgbdslam.frontend.extractor import Extractor
from rgbdslam.frontend.matcher import match_descriptors, match_frames
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset

CAM = Camera(200.0, 200.0, 159.5, 119.5, width=320, height=240)
CFG = ExtractorConfig(num_features=512, num_levels=2, cell_size=8,
                      fast_threshold=15.0, min_response=10.0)


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(n_frames=30, cam=CAM, trajectory="sweep")
    _, g0, d0 = ds.grab(0)
    _, g1, d1 = ds.grab(1)
    return (g0, d0), (g1, d1)


@pytest.mark.parametrize("name", ["star", "brisk", "freak", "latch",
                                  "sift", "surf"])
def test_variant_detects_and_matches(frames, name):
    """Every factory variant detects a healthy keypoint budget on two
    consecutive frames and cross-matches a good fraction of them."""
    (g0, d0), (g1, d1) = frames
    ex = Extractor(CAM, CFG, detector=name)
    f0 = ex(g0, d0)
    f1 = ex(g1, d1)
    n0 = int(f0.valid.sum())
    n1 = int(f1.valid.sum())
    assert n0 > 100 and n1 > 100, (name, n0, n1)
    m = match_frames(f0, f1, 0.9)
    n_m = int(m.num_matches)
    assert n_m > 0.2 * min(n0, n1), (name, n_m, n0, n1)


def test_sift_descriptor_dtype_and_norm(frames):
    (g0, d0), _ = frames
    ex = Extractor(CAM, CFG, detector="sift")
    f = ex(g0, d0)
    desc = np.asarray(f.desc)
    assert desc.dtype == np.float32 and desc.shape[1] == 128
    v = np.asarray(f.valid)
    norms = np.linalg.norm(desc[v], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    # Lowe scheme: clip at 0.2 then renormalize -> entries may exceed 0.2
    # but stay well below an unclipped spike
    assert desc.min() >= 0.0 and desc[v].max() <= 0.6


def test_l2_matcher_identity_and_ratio():
    """L2 path: identical descriptor sets match one-to-one on the diagonal;
    near-duplicate second neighbors fail the ratio test."""
    rng = np.random.default_rng(0)
    d = rng.random((64, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = jnp.ones((64,), bool)
    m = match_descriptors(jnp.asarray(d), valid, jnp.asarray(d), valid, 0.9)
    np.testing.assert_array_equal(np.asarray(m.idx2), np.arange(64))
    assert bool(m.valid.all())
    # duplicate every train row -> best and second-best tie -> ratio kills it
    d2 = np.concatenate([d, d])
    v2 = jnp.ones((128,), bool)
    m2 = match_descriptors(jnp.asarray(d), valid, jnp.asarray(d2), v2, 0.9)
    assert int(m2.valid.sum()) == 0


def test_binary_patterns_differ():
    """BRISK/FREAK/BRIEF produce distinct descriptors on the same frame
    (different geometry, same machinery)."""
    ds = SyntheticDataset(n_frames=2, cam=CAM, trajectory="sweep")
    _, g, d = ds.grab(0)
    descs = {}
    for name in ("svo_fast", "brisk", "freak"):
        ex = Extractor(CAM, CFG, detector=name)
        descs[name] = np.asarray(ex(g, d).desc)
    assert not np.array_equal(descs["svo_fast"], descs["brisk"])
    assert not np.array_equal(descs["brisk"], descs["freak"])


def test_response_maps_finite():
    from rgbdslam.ops import fast as fast_ops

    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.integers(0, 256, (120, 160)).astype(np.float32))
    for name in ("star", "dog", "hessian"):
        masked, raw = fast_ops.response_masked_score(img, name)
        assert np.isfinite(np.asarray(raw)).all()
        kept = np.isfinite(np.asarray(masked))
        assert 0 < kept.sum() < kept.size
