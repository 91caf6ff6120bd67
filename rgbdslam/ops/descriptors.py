"""Descriptor family breadth: BRISK / FREAK / LATCH-style binary patterns and
a SIFT-class float descriptor, all on the patch-matmul machinery.

The reference's Extractor factory offers BRISK, FREAK, BRIEF, LATCH, SURF and
SIFT descriptor types next to ORB (Features/Extractor.h:13-26); its Matcher
picks Hamming or L2 from the descriptor dtype (Features/Matcher.cpp:16,
Extractor::mNorm). Array-program equivalents:

- binary families = deterministic sampling patterns -> bilinear one-hot
  selector matrices -> two matmuls over flattened patches -> compare +
  bit-pack (exactly the BRIEF fast path in ops/orb.py, different geometry):
  * BRISK: points on concentric rings, short-distance pairs (Leutenegger's
    short-pair set drives the descriptor; long pairs only feed orientation).
  * FREAK: retinal layout — density falls off exponentially from the fovea;
    coarse-to-fine pair selection.
  * LATCH-style: triplet comparisons |mean(a)-mean(c)|^2 < |mean(b)-mean(c)|^2
    of 3x3 block means (block means come free from sampling a box-filtered
    image — the full LATCH patch-SSD is approximated by its mean term).
- SIFT-class float descriptor: 4x4 spatial cells x 8 orientation bins of
  gradient magnitude over the patch, hard-assigned bins, per-bin masked
  matmuls, L2-normalize -> clip 0.2 -> renormalize. Matched with the L2
  matcher path (frontend/matcher.py dispatches on dtype).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.ops.orb import DESC_BITS, _pack_bits, extract_patches

# ---------------------------------------------------------------------------
# sampling patterns (deterministic; internal consistency is what matters —
# the vocabulary and matcher both run on our own descriptors)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def brisk_pattern(patch_size: int = 31) -> np.ndarray:
    """(256, 2, 2) short-distance pairs over concentric rings.

    Ring layout after Leutenegger et al.: 4 rings x [10, 14, 15, 20] points
    + center, radii scaled into the patch; pairs are the closest point pairs
    (short pairs), deterministic.
    """
    half = patch_size // 2
    pts = [(0.0, 0.0)]
    for radius_f, n in ((0.25, 10), (0.45, 14), (0.65, 15), (0.85, 20)):
        r = radius_f * half
        for i in range(n):
            a = 2.0 * np.pi * i / n + (0.5 if n % 2 else 0.0)
            pts.append((r * np.cos(a), r * np.sin(a)))
    pts = np.asarray(pts, dtype=np.float32)          # (60, 2)
    # all pairs sorted by distance; keep the 256 shortest non-degenerate
    iu, ju = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[iu] - pts[ju], axis=-1)
    order = np.argsort(d, kind="stable")[:DESC_BITS]
    a = pts[iu[order]]
    b = pts[ju[order]]
    return np.stack([a, b], axis=1)                  # (256, 2, 2)


@functools.lru_cache()
def freak_pattern(patch_size: int = 31, seed: int = 11) -> np.ndarray:
    """(256, 2, 2) retinal pattern: 7 rings + fovea with exponentially
    shrinking radius; coarse-to-fine pairs (outer-ring pairs first), filled
    deterministically from a seeded shuffle of each band."""
    half = patch_size // 2
    rng = np.random.default_rng(seed)
    rings = []
    n_rings = 8
    for k in range(n_rings):
        r = half * (0.9 * (0.7 ** k))
        n = 6 if k < n_rings - 1 else 1
        ring = []
        for i in range(n):
            a = 2.0 * np.pi * i / n + k * 0.4
            ring.append((r * np.cos(a), r * np.sin(a)))
        rings.append(np.asarray(ring, dtype=np.float32))
    pts = np.concatenate(rings)                      # (43, 2)
    iu, ju = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[iu] - pts[ju], axis=-1)
    # coarse-to-fine: sort by DESCENDING pair distance, then subsample
    order = np.argsort(-d, kind="stable")
    keep = rng.permutation(order[: 2 * DESC_BITS])[:DESC_BITS]
    keep.sort()
    a = pts[iu[keep]]
    b = pts[ju[keep]]
    return np.stack([a, b], axis=1)


@functools.lru_cache()
def _pattern_selectors_bilinear(name: str, patch_size: int = 31):
    """(P^2, 256) bilinear selector matrices for a named float pattern."""
    pat = {"brisk": brisk_pattern, "freak": freak_pattern}[name](patch_size)
    half = patch_size // 2
    p2 = patch_size * patch_size
    sel = np.zeros((2, p2, DESC_BITS), dtype=np.float32)
    for k in range(DESC_BITS):
        for ab in range(2):
            x, y = pat[k, ab]
            x = min(max(float(x), -half), half - 1e-3)
            y = min(max(float(y), -half), half - 1e-3)
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            dx, dy = x - x0, y - y0
            for (xx, yy, w) in ((x0, y0, (1 - dx) * (1 - dy)),
                                (x0 + 1, y0, dx * (1 - dy)),
                                (x0, y0 + 1, (1 - dx) * dy),
                                (x0 + 1, y0 + 1, dx * dy)):
                xx = min(max(xx, -half), half)
                yy = min(max(yy, -half), half)
                sel[ab, (yy + half) * patch_size + (xx + half), k] += w
    return sel[0], sel[1]


def pattern_descriptors_dense(img_blurred: jnp.ndarray, uv: jnp.ndarray,
                              pattern: str, patch_size: int = 31
                              ) -> jnp.ndarray:
    """Upright binary descriptor for a named pattern ('brisk' | 'freak'):
    patch extraction + two selector matmuls + compare + pack, identical
    machinery to brief_descriptors_dense."""
    flat = extract_patches(img_blurred, uv, patch_size)     # (N, P^2)
    sel_a, sel_b = _pattern_selectors_bilinear(pattern, patch_size)
    sa = flat @ jnp.asarray(sel_a)
    sb = flat @ jnp.asarray(sel_b)
    return _pack_bits(sa < sb)


@functools.lru_cache()
def _latch_triplets(patch_size: int = 31, seed: int = 17) -> np.ndarray:
    """(256, 3, 2) anchor/a/b block centers for the LATCH-style triplet test,
    drawn like BRIEF pairs plus an anchor."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2 - 1   # leave room for the 3x3 block
    sigma = patch_size / 5.0
    pts = rng.normal(scale=sigma, size=(DESC_BITS, 3, 2))
    return np.clip(pts, -half, half).astype(np.float32)


@functools.lru_cache()
def _latch_selectors(patch_size: int = 31):
    tri = _latch_triplets(patch_size)
    half = patch_size // 2
    p2 = patch_size * patch_size
    sel = np.zeros((3, p2, DESC_BITS), dtype=np.float32)
    for k in range(DESC_BITS):
        for s in range(3):
            x, y = np.round(tri[k, s]).astype(int)
            sel[s, (y + half) * patch_size + (x + half), k] = 1.0
    return sel[0], sel[1], sel[2]


def latch_descriptors_dense(img_box3: jnp.ndarray, uv: jnp.ndarray,
                            patch_size: int = 31) -> jnp.ndarray:
    """LATCH-style triplet descriptor on 3x3 block means.

    img_box3 must be the 3x3 box-mean image (block means of the raw image);
    bit k = (mean(a_k) - mean(anchor_k))^2 < (mean(b_k) - mean(anchor_k))^2.
    """
    flat = extract_patches(img_box3, uv, patch_size)
    sel_a, sel_b, sel_c = _latch_selectors(patch_size)
    sa = flat @ jnp.asarray(sel_a)
    sb = flat @ jnp.asarray(sel_b)
    sc = flat @ jnp.asarray(sel_c)
    return _pack_bits((sa - sc) ** 2 < (sb - sc) ** 2)


# ---------------------------------------------------------------------------
# SIFT-class float descriptor (L2 matching path)
# ---------------------------------------------------------------------------

SIFT_CELLS = 4        # 4x4 spatial cells
SIFT_BINS = 8         # orientation bins
SIFT_DIM = SIFT_CELLS * SIFT_CELLS * SIFT_BINS   # 128


@functools.lru_cache()
def _sift_cell_weights(patch_size: int = 16) -> np.ndarray:
    """(P^2, 16) spatial cell indicator weighted by a Gaussian window."""
    p2 = patch_size * patch_size
    cw = np.zeros((p2, SIFT_CELLS * SIFT_CELLS), dtype=np.float32)
    half = patch_size / 2.0
    cell = patch_size // SIFT_CELLS
    for yy in range(patch_size):
        for xx in range(patch_size):
            cy, cx = min(yy // cell, 3), min(xx // cell, 3)
            g = np.exp(-((xx - half + 0.5) ** 2 + (yy - half + 0.5) ** 2)
                       / (2.0 * (0.5 * patch_size) ** 2))
            cw[yy * patch_size + xx, cy * SIFT_CELLS + cx] = g
    return cw


def sift_descriptors_dense(img_blurred: jnp.ndarray, uv: jnp.ndarray,
                           patch_size: int = 16) -> jnp.ndarray:
    """(N, 128) f32 SIFT-class descriptor: per-patch gradient-orientation
    histograms over a 4x4 cell grid, hard orientation assignment, Gaussian
    spatial window, L2-normalize -> clip 0.2 -> renormalize (Lowe).

    Upright (no dominant-orientation rotation) — matching the upright-BRIEF
    live path; the reference's cv::SIFT would rotate, which only matters
    under camera roll.
    """
    p = patch_size
    flat = extract_patches(img_blurred, uv, p + 2)          # (N, (p+2)^2)
    patches = flat.reshape(-1, p + 2, p + 2)
    dx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]       # (N, p, p)
    dy = patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)                               # [-pi, pi]
    binf = (ang + jnp.pi) / (2.0 * jnp.pi) * SIFT_BINS
    bins = jnp.clip(binf.astype(jnp.int32), 0, SIFT_BINS - 1)

    cw = jnp.asarray(_sift_cell_weights(p))                 # (p^2, 16)
    mag_f = mag.reshape(-1, p * p)
    bins_f = bins.reshape(-1, p * p)
    hists = []
    for b in range(SIFT_BINS):
        mb = jnp.where(bins_f == b, mag_f, 0.0)             # (N, p^2)
        hists.append(mb @ cw)                               # (N, 16)
    desc = jnp.stack(hists, axis=-1).reshape(-1, SIFT_DIM)  # (N, 128)

    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-6)
    desc = jnp.minimum(desc, 0.2)
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    return desc / jnp.maximum(norm, 1e-6)
