"""Frontend tests: image ops, FAST detection, descriptors, matching."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbdslam.config import ExtractorConfig
from rgbdslam.frontend.frame import build_frame_features
from rgbdslam.frontend.matcher import match_descriptors, match_frames
from rgbdslam.geometry.camera import Camera
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.ops import fast as fast_ops
from rgbdslam.ops import hamming, image as image_ops
from rgbdslam.ops import orb as orb_ops

CAM = Camera(160.0, 160.0, 127.5, 95.5, width=256, height=192)
CFG = ExtractorConfig(num_features=256, num_levels=3, cell_size=16)


def polka(h, w, cell=16, lo=40.0, hi=220.0):
    """Isolated bright squares on dark background: L-junction corners that
    FAST responds to (ideal checkerboard X-junctions do not trigger the
    segment test — true of libfast as well)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    inside = ((yy % cell) >= 4) & ((yy % cell) < cell - 4) & \
             ((xx % cell) >= 4) & ((xx % cell) < cell - 4)
    return np.where(inside, hi, lo).astype(np.float32)


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

def test_half_sample():
    img = jnp.arange(16.0).reshape(4, 4)
    out = np.asarray(image_ops.half_sample(img))
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out[0, 0], np.mean([0, 1, 4, 5]))


def test_gaussian_blur_preserves_mean():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (64, 64)).astype(np.float32))
    out = image_ops.gaussian_blur(img)
    assert abs(float(out.mean()) - float(img.mean())) < 1.0
    assert float(out.std()) < float(img.std())


def test_bilinear_sample_exact_on_grid():
    img = jnp.arange(12.0).reshape(3, 4)
    uv = jnp.array([[1.0, 2.0], [0.0, 0.0], [3.0, 2.0]])
    vals = np.asarray(image_ops.bilinear_sample(img, uv))
    np.testing.assert_allclose(vals, [9.0, 0.0, 11.0])


def test_bilinear_sample_interpolates():
    img = jnp.array([[0.0, 10.0], [20.0, 30.0]])
    v = float(image_ops.bilinear_sample(img, jnp.array([[0.5, 0.5]]))[0])
    assert abs(v - 15.0) < 1e-5


# ---------------------------------------------------------------------------
# FAST + Shi-Tomasi
# ---------------------------------------------------------------------------

def test_fast_mask_matches_opencv():
    """Dense FAST-10 agrees with OpenCV FAST (TYPE_9_16 is FAST-9; compare our
    arc=9 variant) on a natural-looking image."""
    cv2 = pytest.importorskip("cv2")
    ds = SyntheticDataset(n_frames=1, cam=CAM)
    _, gray, _ = ds.grab(0)
    g8 = np.asarray(gray).astype(np.uint8)
    det = cv2.FastFeatureDetector_create(
        threshold=20, nonmaxSuppression=False, type=cv2.FastFeatureDetector_TYPE_9_16
    )
    kps = det.detect(g8, None)
    ref = np.zeros(g8.shape, dtype=bool)
    for kp in kps:
        ref[int(round(kp.pt[1])), int(round(kp.pt[0]))] = True

    ours = np.asarray(
        fast_ops.fast_corner_mask(jnp.asarray(g8, dtype=jnp.float32), 20.0, arc=9)
    )
    # interior comparison (border semantics differ)
    inner = np.s_[4:-4, 4:-4]
    agree = (ours[inner] == ref[inner]).mean()
    assert agree > 0.995, f"FAST agreement {agree}"
    # and actual corners exist
    assert ref[inner].sum() > 50


def test_shi_tomasi_matches_reference_pointwise():
    """Dense Shi-Tomasi equals the SVO per-pixel routine re-implemented in
    numpy (Features/SVOextractor.cpp:39-77 semantics, symmetric window)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (32, 32)).astype(np.float32)

    def ref_score(img, u, v, r=4):
        dxx = dyy = dxy = 0.0
        for y in range(v - r, v + r + 1):
            for x in range(u - r, u + r + 1):
                dx = float(img[y, x + 1]) - float(img[y, x - 1])
                dy = float(img[y + 1, x]) - float(img[y - 1, x])
                dxx += dx * dx
                dyy += dy * dy
                dxy += dx * dy
        area = (2 * r + 1) ** 2
        dxx /= 2 * area
        dyy /= 2 * area
        dxy /= 2 * area
        return 0.5 * (dxx + dyy - np.sqrt((dxx + dyy) ** 2 - 4 * (dxx * dyy - dxy * dxy)))

    smap = np.asarray(fast_ops.shi_tomasi_map(jnp.asarray(img)))
    for (u, v) in [(10, 10), (16, 8), (20, 20)]:
        assert abs(smap[v, u] - ref_score(img, u, v)) < 1e-2 * max(1.0, abs(smap[v, u]))


def test_detect_keypoints_on_polka_grid():
    img = jnp.asarray(polka(192, 256))
    pyr = image_ops.build_pyramid(img, 3)
    kp = fast_ops.detect_keypoints(pyr, 256, 16, 20.0, 20.0, 16)
    n = int(kp.valid.sum())
    assert n > 50, n  # square corners found
    uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
    # all inside borders
    assert uv[:, 0].min() >= 16 and uv[:, 0].max() < 256 - 16
    assert uv[:, 1].min() >= 16 and uv[:, 1].max() < 192 - 16
    # detections land near square corners (offsets 4 or 11 in each cell)
    mod = uv % 16
    near = np.minimum(np.abs(mod - 4), np.abs(mod - 12))
    assert np.median(near) <= 2.5


def test_detect_keypoints_grid_spread():
    """Best-per-cell: no two valid keypoints share a 16px cell."""
    ds = SyntheticDataset(n_frames=1, cam=CAM)
    _, gray, _ = ds.grab(0)
    pyr = image_ops.build_pyramid(gray, 3)
    kp = fast_ops.detect_keypoints(pyr, 256, 16, 20.0, 20.0, 16)
    uv = np.asarray(kp.uv)[np.asarray(kp.valid)]
    cells = (uv[:, 1] // 16).astype(int) * 100 + (uv[:, 0] // 16).astype(int)
    assert len(np.unique(cells)) == len(cells)
    assert len(cells) > 60


# ---------------------------------------------------------------------------
# descriptors + matching
# ---------------------------------------------------------------------------

def test_descriptor_stability_under_translation():
    """Same world texture shifted by a whole pixel -> near-identical descriptors."""
    ds = SyntheticDataset(n_frames=1, cam=CAM)
    _, gray, _ = ds.grab(0)
    g = np.asarray(gray)
    sh = np.roll(g, 5, axis=1)
    uv = jnp.asarray(
        np.stack(
            [np.random.default_rng(2).uniform(30, 220, 64),
             np.random.default_rng(3).uniform(30, 160, 64)],
            axis=-1,
        ).astype(np.float32)
    )
    b1 = image_ops.gaussian_blur(jnp.asarray(g))
    b2 = image_ops.gaussian_blur(jnp.asarray(sh))
    d1 = orb_ops.brief_descriptors(b1, uv)
    d2 = orb_ops.brief_descriptors(b2, uv + jnp.array([5.0, 0.0]))
    dist = np.asarray(hamming.popcount_rows(d1 ^ d2))
    assert np.median(dist) <= 8  # out of 256 bits


def test_dense_brief_matches_numpy_reference():
    """The dense bit-plane BRIEF equals a direct numpy evaluation of the
    integer pattern at each keypoint."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    uv = np.stack(
        [rng.integers(16, 112, 32), rng.integers(16, 80, 32)], axis=-1
    ).astype(np.float32)
    ours = np.asarray(
        orb_ops.brief_descriptors_dense(jnp.asarray(img), jnp.asarray(uv))
    )
    pat = orb_ops._int_pattern()
    ref = np.zeros((32, 8), dtype=np.uint32)
    for i, (u, v) in enumerate(uv.astype(int)):
        for k in range(256):
            ax, ay = pat[k, 0]
            bx, by = pat[k, 1]
            bit = img[v + ay, u + ax] < img[v + by, u + bx]
            if bit:
                ref[i, k // 32] |= np.uint32(1 << (k % 32))
    np.testing.assert_array_equal(ours, ref)


def test_hamming_distance_matrix_matches_numpy():
    rng = np.random.default_rng(4)
    d1 = rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, size=(24, 8), dtype=np.uint32)
    D = np.asarray(hamming.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    ref = np.zeros((16, 24), dtype=np.int64)
    for i in range(16):
        for j in range(24):
            ref[i, j] = bin(int.from_bytes(d1[i].tobytes(), "little")
                            ^ int.from_bytes(d2[j].tobytes(), "little")).count("1")
    np.testing.assert_array_equal(D, ref)


def test_match_descriptors_identity():
    rng = np.random.default_rng(5)
    d = jnp.asarray(rng.integers(0, 2**32, size=(64, 8), dtype=np.uint32))
    valid = jnp.ones((64,), dtype=bool)
    m = match_descriptors(d, valid, d, valid, ratio=0.9)
    idx = np.asarray(m.idx2)
    v = np.asarray(m.valid)
    assert v.all()
    np.testing.assert_array_equal(idx, np.arange(64))
    assert np.asarray(m.dist)[v].max() == 0


def test_match_descriptors_respects_validity():
    rng = np.random.default_rng(6)
    d = jnp.asarray(rng.integers(0, 2**32, size=(32, 8), dtype=np.uint32))
    valid1 = jnp.ones((32,), dtype=bool).at[5].set(False)
    valid2 = jnp.ones((32,), dtype=bool).at[7].set(False)
    m = match_descriptors(d, valid1, d, valid2, ratio=0.9)
    v = np.asarray(m.valid)
    assert not v[5]          # invalid query
    assert not v[7]          # its best train (7) is invalid
    assert v.sum() >= 28


def test_match_frames_on_synthetic_pair():
    """Two adjacent synthetic views: matches exist and are geometrically
    consistent with the ground-truth relative pose."""
    ds = SyntheticDataset(n_frames=60, cam=CAM)
    t0, g0, z0 = ds.grab(0)
    t1, g1, z1 = ds.grab(1)
    f0 = build_frame_features(CAM, g0, z0, CFG)
    f1 = build_frame_features(CAM, g1, z1, CFG)
    m = match_frames(f0, f1)
    nm = int(m.num_matches)
    assert nm > 40, f"too few matches: {nm}"

    # check geometric consistency: T21_gt maps f0 camera points to f1 camera
    T0 = ds.poses_twc[0]
    T1 = ds.poses_twc[1]
    T21 = np.linalg.inv(T1) @ T0
    p1 = np.asarray(f0.xyz)
    p2 = np.asarray(f1.xyz)[np.asarray(m.idx2)]
    vmask = np.asarray(m.valid)
    pred = p1[vmask] @ T21[:3, :3].T + T21[:3, 3]
    err = np.linalg.norm(pred - p2[vmask], axis=-1)
    # most matches should agree within a few cm (texture is blocky; nearest-
    # neighbor depth adds noise)
    assert np.median(err) < 0.05, f"median 3D match error {np.median(err)}"


def test_oriented_orb_rotation_invariance():
    """Steered BRIEF: descriptors of the same patch under in-plane rotation
    should be much closer than upright BRIEF's."""
    rng = np.random.default_rng(12)
    # a textured image rotated by 90 deg (exact, no interpolation artifacts)
    img = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    img_s = np.asarray(image_ops.gaussian_blur(jnp.asarray(img), 2.0, 3))
    rot = np.rot90(img).copy()
    rot_s = np.asarray(image_ops.gaussian_blur(jnp.asarray(rot), 2.0, 3))

    # keypoints away from borders; their rotated positions
    uv = np.stack([rng.integers(30, 98, 48), rng.integers(30, 98, 48)],
                  axis=-1).astype(np.float32)
    # np.rot90: out[i, j] = in[j, W-1-i]  => point (u,v) -> (v, W-1-u)
    uv_rot = np.stack([uv[:, 1], 127 - uv[:, 0]], axis=-1).astype(np.float32)

    d1, a1 = orb_ops.orb_descriptors_dense(jnp.asarray(img_s), jnp.asarray(img),
                                           jnp.asarray(uv))
    d2, a2 = orb_ops.orb_descriptors_dense(jnp.asarray(rot_s), jnp.asarray(rot),
                                           jnp.asarray(uv_rot))
    dist_orb = np.asarray(hamming.popcount_rows(d1 ^ d2))

    u1 = orb_ops.brief_descriptors_dense(jnp.asarray(img_s), jnp.asarray(uv))
    u2 = orb_ops.brief_descriptors_dense(jnp.asarray(rot_s), jnp.asarray(uv_rot))
    dist_up = np.asarray(hamming.popcount_rows(u1 ^ u2))

    assert np.median(dist_orb) < 60, np.median(dist_orb)
    assert np.median(dist_up) > 100          # upright breaks under 90 deg
    assert np.median(dist_orb) < 0.6 * np.median(dist_up)


def test_orb_angles_consistent_under_rotation():
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 255, (128, 128)).astype(np.float32)
    rot = np.rot90(img).copy()
    uv = np.stack([rng.integers(30, 98, 32), rng.integers(30, 98, 32)],
                  axis=-1).astype(np.float32)
    uv_rot = np.stack([uv[:, 1], 127 - uv[:, 0]], axis=-1).astype(np.float32)
    _, a1 = orb_ops.orb_descriptors_dense(jnp.asarray(img), jnp.asarray(img), jnp.asarray(uv))
    _, a2 = orb_ops.orb_descriptors_dense(jnp.asarray(rot), jnp.asarray(rot), jnp.asarray(uv_rot))
    # np.rot90 rotates image content by +90deg CCW in (x,y)-display terms;
    # in (u right, v down) pixel coords the patch content rotates so angles
    # shift by -pi/2 (mod 2pi)
    diff = np.mod(np.asarray(a2) - np.asarray(a1) + np.pi / 2 + np.pi,
                  2 * np.pi) - np.pi
    assert np.median(np.abs(diff)) < 0.2, np.median(np.abs(diff))
