"""Fused detector vs the plain composition (its reference).

ops/fast.masked_score_map (one chain of fused shifts, the live detector)
must reproduce the FAST + Shi-Tomasi + 3x3-NMS semantics of
ops/fast.masked_score_map_reference (reference semantics:
Features/SVOextractor.cpp:79-133). tests/test_gpu_kernels.py repeats the
comparison on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.ops import fast as fast_ops
from rgbdslam.ops.fast import FAST_RING

fused = fast_ops.masked_score_map
reference = fast_ops.masked_score_map_reference


def _random_image(shape, seed=0):
    rng = np.random.default_rng(seed)
    # integer-valued f32: box sums are exact in both summation orders
    return jnp.asarray(rng.integers(0, 256, shape).astype(np.float32))


def assert_detect_parity(a, ra, b, rb):
    """Identical keep masks; scores equal up to summation-order rounding."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(np.asarray(ra), np.asarray(rb),
                               rtol=1e-5, atol=1e-3)
    ka, kb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(ka, kb)
    assert ka.sum() > 0
    np.testing.assert_allclose(a[ka], b[ka], rtol=1e-5, atol=1e-3)


# the 4-level pyramid of a 640x480 frame, plus small and odd sizes
@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (120, 160),
                                   (60, 80), (30, 40), (37, 53)])
def test_fused_detect_matches_xla(shape):
    img = _random_image(shape, seed=sum(shape))
    a, ra = reference(img, 20.0)
    b, rb = fused(img, 20.0)
    assert_detect_parity(a, ra, b, rb)


def test_fused_detect_gftt_mode():
    img = _random_image((120, 160), seed=7)
    a = np.asarray(reference(img, 20.0, use_fast_gate=False)[0])
    b = np.asarray(fused(img, 20.0, use_fast_gate=False)[0])
    ka, kb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_allclose(a[ka], b[ka], rtol=1e-5, atol=1e-3)


def test_fused_detect_threshold_is_traced():
    """The threshold is an operand: different thresholds, one compiled
    program, different corner counts (adaptive-mode requirement)."""
    img = _random_image((120, 160), seed=3)
    run = jax.jit(lambda im, t: fused(im, t)[0])
    lo = np.isfinite(np.asarray(run(img, 10.0))).sum()
    hi = np.isfinite(np.asarray(run(img, 60.0))).sum()
    assert lo > hi > 0
    assert run._cache_size() == 1


def test_detect_keypoints_pallas_end_to_end(monkeypatch):
    """detect_keypoints produces the same keypoint set through the fused
    detector and the plain composition (integer detections)."""
    img = _random_image((240, 320), seed=11)
    pyr = [img, jnp.asarray(np.asarray(img)[::2, ::2])]
    kw = dict(num_features=256, cell_size=10, fast_threshold=20.0,
              min_response=20.0, min_border=8, subpixel=False)
    kp_b = fast_ops.detect_keypoints(pyr, **kw)
    monkeypatch.setattr(fast_ops, "masked_score_map", reference)
    kp_a = fast_ops.detect_keypoints(pyr, **kw)
    assert bool(jnp.array_equal(kp_a.valid, kp_b.valid))
    a_uv = np.asarray(kp_a.uv)[np.asarray(kp_a.valid)]
    b_uv = np.asarray(kp_b.uv)[np.asarray(kp_b.valid)]
    # same cells win; allow reordering within equal scores
    assert {tuple(r) for r in a_uv} == {tuple(r) for r in b_uv}


def test_detect_keypoints_subpixel():
    """Subpixel refinement moves winners by at most +-0.5 px per axis (scaled
    by the pyramid level) and recovers a synthetic corner's true offset."""
    img = _random_image((240, 320), seed=13)
    pyr = [img]
    kw = dict(num_features=256, cell_size=10, fast_threshold=20.0,
              min_response=20.0, min_border=8)
    kp_i = fast_ops.detect_keypoints(pyr, subpixel=False, **kw)
    kp_s = fast_ops.detect_keypoints(pyr, subpixel=True, **kw)
    v = np.asarray(kp_i.valid)
    d = np.abs(np.asarray(kp_s.uv) - np.asarray(kp_i.uv))[v]
    assert d.max() <= 0.5 + 1e-5
    assert d.max() > 0.0   # something actually moved


def fast10_oracle(img: np.ndarray, t: float, arc: int = 10) -> np.ndarray:
    """Per-pixel loop of the libfast segment test: a pixel is a corner when
    `arc` contiguous ring pixels (with wrap-around) are all brighter than
    center + t or all darker than center - t; the 3-px border is not
    tested."""
    h, w = img.shape
    out = np.zeros((h, w), bool)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            c = img[y, x]
            ring = np.array([img[y + dy, x + dx] for dx, dy in FAST_RING])
            for flags in (ring > c + t, ring < c - t):
                ext = np.concatenate([flags, flags[:arc - 1]])
                if any(ext[s:s + arc].all() for s in range(16)):
                    out[y, x] = True
                    break
    return out


@pytest.mark.parametrize("path", ["reference", "fused"])
def test_fast10_matches_numpy_oracle(path):
    img = _random_image((40, 56), seed=21)
    want = fast10_oracle(np.asarray(img), 20.0)
    assert want.sum() > 0
    if path == "reference":
        got = np.asarray(fast_ops.fast_corner_mask(img, 20.0))
    else:
        # the fused map keeps exactly the FAST corners that win their 3x3
        # Shi-Tomasi neighbourhood among corners
        raw = np.asarray(fast_ops.shi_tomasi_map(img))
        cs = np.where(want, raw, -np.inf)
        pad = np.pad(cs, 1, constant_values=-np.inf)
        h, w = cs.shape
        nb = np.max([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
        want = want & (cs >= nb)
        got = np.isfinite(np.asarray(fused(img, 20.0)[0]))
    np.testing.assert_array_equal(got, want)
