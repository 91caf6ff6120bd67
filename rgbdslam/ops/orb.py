"""Binary descriptors (BRIEF-256 / rotated ORB-style) + intensity-centroid
orientation, vectorized over a fixed keypoint budget.

The reference's live path uses OpenCV's (upright) BRIEF descriptor on SVO-FAST
keypoints (main.cpp:31, Features/Extractor.cpp:59); the alternative
ORBextractor implements rotated BRIEF with the learned 256-pair pattern and
IC-angle orientation (Features/ORBextractor.cpp:16-87). We implement both
behaviors behind a `use_orientation` flag with a deterministic Gaussian
sampling pattern (BRIEF-GII): pairs drawn N(0, (patch/5)^2), clipped to the
patch, fixed seed — internal consistency is what matters since the loop-closure
vocabulary is trained on our own descriptors, not DBoW3's.

Descriptors are packed 256 bits -> (N, 8) uint32 for XOR+popcount Hamming
matching.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.ops import image as image_ops

DESC_BITS = 256
DESC_WORDS = DESC_BITS // 32


@functools.lru_cache()
def brief_pattern(patch_size: int = 31, seed: int = 7) -> np.ndarray:
    """Deterministic BRIEF-GII pattern: (256, 2, 2) float32 offsets (a, b)."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = rng.normal(scale=sigma, size=(DESC_BITS, 2, 2))
    return np.clip(pts, -half, half).astype(np.float32)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) bool -> (N, 8) uint32, bit i of word w = bits[:, 32*w + i]."""
    n = bits.shape[0]
    b = bits.reshape(n, DESC_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def ic_angles(img: jnp.ndarray, uv: jnp.ndarray, radius: int = 15) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint (ORB IC_Angle,
    Features/ORBextractor.cpp:16-41): angle of (m10, m01) moments over a
    circular patch of the given radius. uv: (N, 2) -> (N,) radians."""
    d = 2 * radius + 1
    ys, xs = np.meshgrid(
        np.arange(-radius, radius + 1), np.arange(-radius, radius + 1), indexing="ij"
    )
    circle = (xs * xs + ys * ys) <= radius * radius
    offs = np.stack([xs[circle], ys[circle]], axis=-1).astype(np.float32)  # (M, 2)
    offs_j = jnp.asarray(offs)

    def one(kp):
        coords = kp[None, :] + offs_j  # (M, 2)
        vals = image_ops.bilinear_sample(img, coords)
        m10 = jnp.sum(vals * offs_j[:, 0])
        m01 = jnp.sum(vals * offs_j[:, 1])
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(uv)


@functools.lru_cache()
def _int_pattern(patch_size: int = 31, seed: int = 7) -> np.ndarray:
    """BRIEF pattern rounded to integer pixel offsets (standard BRIEF uses
    integer offsets on the smoothed image)."""
    return np.round(brief_pattern(patch_size, seed)).astype(np.int32)


@functools.lru_cache()
def _pattern_selectors(patch_size: int = 31, seed: int = 7):
    """One-hot selection matrices (patch_px, 256) for the a/b sample of each
    pair, so per-keypoint sampling becomes two matmuls."""
    pat = _int_pattern(patch_size, seed)
    half = patch_size // 2
    p2 = patch_size * patch_size
    sel_a = np.zeros((p2, DESC_BITS), dtype=np.float32)
    sel_b = np.zeros((p2, DESC_BITS), dtype=np.float32)
    for k in range(DESC_BITS):
        ax, ay = pat[k, 0]
        bx, by = pat[k, 1]
        sel_a[(ay + half) * patch_size + (ax + half), k] = 1.0
        sel_b[(by + half) * patch_size + (bx + half), k] = 1.0
    return sel_a, sel_b


def brief_descriptors_dense(
    img_blurred: jnp.ndarray,
    uv: jnp.ndarray,
    patch_size: int = 31,
) -> jnp.ndarray:
    """Upright BRIEF-256 — the fast path.

    Instead of 512 scattered bilinear gathers per keypoint, per keypoint one
    contiguous 31x31 patch is sliced out (a single batched gather of whole
    rows), and the 512 pattern samples are read out of the flattened patches
    with two constant one-hot matmuls — then compared and packed.
    Exact same bits as evaluating the integer pattern per keypoint.

    Keypoints must lie >= patch//2 pixels inside the border (the detector's
    min_border guarantees this); coordinates are rounded to integers (the
    grid detector emits integer pixels).
    """
    flat = extract_patches(img_blurred, uv, patch_size)    # (N, 961)
    sel_a, sel_b = _pattern_selectors(patch_size)
    sa = flat @ jnp.asarray(sel_a)   # (N, 256)
    sb = flat @ jnp.asarray(sel_b)
    return _pack_bits(sa < sb)


@functools.lru_cache()
def _moment_weights(patch_size: int = 31, radius: int = 15):
    """Per-patch-pixel x/y weights over the IC circle -> two (P^2,) vectors:
    m10 = patch . wx, m01 = patch . wy (matmul-form intensity centroid)."""
    half = patch_size // 2
    ys, xs = np.meshgrid(
        np.arange(-half, half + 1), np.arange(-half, half + 1), indexing="ij"
    )
    circle = (xs * xs + ys * ys) <= radius * radius
    wx = (xs * circle).astype(np.float32).reshape(-1)
    wy = (ys * circle).astype(np.float32).reshape(-1)
    return wx, wy


@functools.lru_cache()
def _rotated_selectors(patch_size: int = 31, n_bins: int = 16, seed: int = 7):
    """One-hot (bilinear-weighted) selector matrices for the BRIEF pattern
    rotated to each of n_bins discrete angles: (P^2, n_bins * 256) for a and
    b samples. Rotated sample positions are bilinearly distributed over the
    4 neighboring patch pixels, so the matmul directly produces interpolated
    intensities (ORB quantizes orientation similarly: 12 deg bins,
    Features/ORBextractor.cpp pattern rotation)."""
    pat = brief_pattern(patch_size, seed)  # float offsets (256, 2, 2)
    half = patch_size // 2
    p2 = patch_size * patch_size
    sel = np.zeros((2, p2, n_bins * DESC_BITS), dtype=np.float32)
    for b in range(n_bins):
        ang = 2.0 * np.pi * b / n_bins
        c, s = np.cos(ang), np.sin(ang)
        for k in range(DESC_BITS):
            for ab in range(2):
                x, y = pat[k, ab]
                xr = c * x - s * y
                yr = s * x + c * y
                # clamp into the patch and bilinearly distribute
                xr = min(max(xr, -half), half - 1e-3)
                yr = min(max(yr, -half), half - 1e-3)
                x0, y0 = int(np.floor(xr)), int(np.floor(yr))
                dx, dy = xr - x0, yr - y0
                for (xx, yy, w) in (
                    (x0, y0, (1 - dx) * (1 - dy)),
                    (x0 + 1, y0, dx * (1 - dy)),
                    (x0, y0 + 1, (1 - dx) * dy),
                    (x0 + 1, y0 + 1, dx * dy),
                ):
                    xx = min(max(xx, -half), half)
                    yy = min(max(yy, -half), half)
                    sel[ab, (yy + half) * patch_size + (xx + half),
                        b * DESC_BITS + k] += w
    return sel[0], sel[1]


def extract_patches(img: jnp.ndarray, uv: jnp.ndarray,
                    patch_size: int = 31) -> jnp.ndarray:
    """(N, patch^2) flattened patches at integer keypoint coords.

    Two-stage extraction instead of a per-element gather of N x P^2
    scattered pixels:
      1. slice a full-width (P, W) horizontal band per keypoint — one gather
         of lane-contiguous rows (memcpy-class), then
      2. select the P columns of each band with a per-keypoint one-hot
         (W+P-1, P) matrix in a single batched matmul (exact: one-hot
         f32 matmul is a copy).
    """
    half = patch_size // 2
    h, w = img.shape
    padded = jnp.pad(img, half, mode="edge")  # (h + P - 1, w + P - 1)
    wp = w + patch_size - 1
    u = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1)
    v = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1)

    # 1. full-width horizontal bands (N, P, WP): lane-contiguous slices
    bands = jax.vmap(
        lambda vi: jax.lax.dynamic_slice(padded, (vi, 0), (patch_size, wp))
    )(v)

    # 2. one-hot column selection as a matmul: cols[n, :, j] = u[n] + j
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, wp, patch_size), 1)
    sel = (cols == (u[:, None, None] +
                    jax.lax.broadcasted_iota(jnp.int32, (1, wp, patch_size), 2))
           ).astype(img.dtype)                       # (N, WP, P)
    patches = jnp.einsum("nrw,nwj->nrj", bands, sel,
                         preferred_element_type=jnp.float32)
    return patches.reshape(patches.shape[0], -1)


def orb_descriptors_dense(
    img_blurred: jnp.ndarray,
    img_raw: jnp.ndarray,
    uv: jnp.ndarray,
    patch_size: int = 31,
    n_bins: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Oriented (steered) BRIEF — the fast path for the 'orb' detector.

    IC-angle moments and all n_bins rotated pattern samplings come from ONE
    patch extraction + a handful of matmuls; each keypoint then selects
    its angle bin. Replaces the per-keypoint gather formulation (ic_angles +
    rotated bilinear sampling).

    Returns (desc (N, 8) uint32, angles (N,) radians).
    """
    # moments from the raw image (IC_Angle uses unsmoothed intensities,
    # Features/ORBextractor.cpp:16-41)
    p_raw = extract_patches(img_raw, uv, patch_size)       # (N, P^2)
    wx, wy = _moment_weights(patch_size)
    m10 = p_raw @ jnp.asarray(wx)
    m01 = p_raw @ jnp.asarray(wy)
    angles = jnp.arctan2(m01, m10)

    n_bins_f = jnp.float32(n_bins)
    bins = jnp.mod(
        jnp.round(angles / (2.0 * jnp.pi) * n_bins_f).astype(jnp.int32), n_bins
    )

    p_blur = extract_patches(img_blurred, uv, patch_size)  # (N, P^2)
    sel_a, sel_b = _rotated_selectors(patch_size, n_bins)
    sa = (p_blur @ jnp.asarray(sel_a)).reshape(-1, n_bins, DESC_BITS)
    sb = (p_blur @ jnp.asarray(sel_b)).reshape(-1, n_bins, DESC_BITS)
    take = bins[:, None, None]
    sa_sel = jnp.take_along_axis(sa, take, axis=1)[:, 0, :]  # (N, 256)
    sb_sel = jnp.take_along_axis(sb, take, axis=1)[:, 0, :]
    return _pack_bits(sa_sel < sb_sel), angles


def brief_descriptors(
    img_blurred: jnp.ndarray,
    uv: jnp.ndarray,
    angles: jnp.ndarray | None = None,
    patch_size: int = 31,
) -> jnp.ndarray:
    """Compute packed 256-bit descriptors at level-0 coords on a pre-blurred
    image (the reference blurs before describing, Features/ORBextractor.cpp:746).

    uv: (N, 2); angles: optional (N,) for steered (rotated) BRIEF.
    Returns (N, 8) uint32.
    """
    pat = jnp.asarray(brief_pattern(patch_size))  # (256, 2, 2)
    a = pat[:, 0, :]  # (256, 2)
    b = pat[:, 1, :]

    if angles is not None:
        cos = jnp.cos(angles)
        sin = jnp.sin(angles)

        def rotate(offs, c, s):
            x, y = offs[:, 0], offs[:, 1]
            return jnp.stack([c * x - s * y, s * x + c * y], axis=-1)

        def one(kp, c, s):
            pa = kp[None, :] + rotate(a, c, s)
            pb = kp[None, :] + rotate(b, c, s)
            ia = image_ops.bilinear_sample(img_blurred, pa)
            ib = image_ops.bilinear_sample(img_blurred, pb)
            return ia < ib

        bits = jax.vmap(one)(uv, cos, sin)
    else:

        def one_upright(kp):
            ia = image_ops.bilinear_sample(img_blurred, kp[None, :] + a)
            ib = image_ops.bilinear_sample(img_blurred, kp[None, :] + b)
            return ia < ib

        bits = jax.vmap(one_upright)(uv)

    return _pack_bits(bits)
