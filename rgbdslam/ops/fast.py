"""Dense FAST corner detection + Shi-Tomasi scoring + grid NMS, fully
vectorized.

Array-program re-design of the reference's SVO-style detector
(Features/SVOextractor.cpp:79-133): instead of libfast's sequential
`fast_corner_detect_10` + per-corner Shi-Tomasi + per-cell occupancy loop, we
compute, per pyramid level, a *dense* FAST-10 segment-test mask and a dense
Shi-Tomasi min-eigenvalue map (separable box sums), 3x3 non-max
suppression, and a best-per-grid-cell reduction — then merge levels and select
the top-N cells into a fixed keypoint budget. Data-dependent keypoint counts
become a validity mask over N static slots.

Design divergences from the reference (documented, behavior-preserving):
- 3x3 NMS ranks by Shi-Tomasi score instead of the libfast corner score
  (Features/SVOextractor.cpp:106-108); the subsequent per-cell argmax is by
  Shi-Tomasi in both.
- Shi-Tomasi uses a symmetric (2r+1)^2 window (r=4) instead of the reference's
  8x8 window anchored at [u-4, u+4) (Features/SVOextractor.cpp:46-70).
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.ops import image as image_ops

# Bresenham circle of radius 3 — the 16 FAST ring offsets (dx, dy), clockwise
# from 12 o'clock (same ring as libfast / OpenCV FAST).
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
FAST_ARC = 10    # FAST-10: contiguous ring pixels a corner needs
ST_RADIUS = 4    # Shi-Tomasi box window (2r+1)^2


def fast_corner_mask(img: jnp.ndarray, threshold: float,
                     arc: int = FAST_ARC) -> jnp.ndarray:
    """Dense FAST segment test: True where >= `arc` contiguous ring pixels are
    all brighter than center+t or all darker than center-t.

    Equivalent decision rule to libfast's fast_corner_detect_10
    (Features/SVOextractor.cpp:101-102), evaluated at every pixel at once.
    """
    h, w = img.shape
    center = img
    ring = []
    for dx, dy in FAST_RING:
        # shift so that ring[k][y, x] = img[y+dy, x+dx]; out-of-range pixels
        # are replicated (border rows are masked out below anyway).
        shifted = jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))
        ring.append(shifted)
    ring = jnp.stack(ring, axis=0)  # (16, H, W)

    brighter = ring > (center + threshold)[None]
    darker = ring < (center - threshold)[None]

    def has_arc(flags: jnp.ndarray) -> jnp.ndarray:
        # wrap-around: concatenate first arc-1 entries, then AND over each
        # window of `arc` consecutive ring positions.
        ext = jnp.concatenate([flags, flags[: arc - 1]], axis=0)  # (16+arc-1, H, W)
        out = jnp.zeros(flags.shape[1:], dtype=bool)
        for s in range(16):
            window = ext[s : s + arc]
            out = out | jnp.all(window, axis=0)
        return out

    mask = has_arc(brighter) | has_arc(darker)
    # invalidate the 3-pixel border (ring reads wrap there)
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return mask & interior


def shi_tomasi_map(img: jnp.ndarray, radius: int = ST_RADIUS) -> jnp.ndarray:
    """Dense Shi-Tomasi min-eigenvalue score (SVO ShiTomasiScore semantics,
    Features/SVOextractor.cpp:39-77: central-difference gradients, box sum,
    normalization by 2*box_area)."""
    dx, dy = image_ops.sobel_gradients(img)
    area = float((2 * radius + 1) ** 2)
    dxx = image_ops.box_filter_sum(dx * dx, radius) / (2.0 * area)
    dyy = image_ops.box_filter_sum(dy * dy, radius) / (2.0 * area)
    dxy = image_ops.box_filter_sum(dx * dy, radius) / (2.0 * area)
    tr = dxx + dyy
    det_term = jnp.sqrt(jnp.maximum((dxx - dyy) ** 2 + 4.0 * dxy * dxy, 0.0))
    return 0.5 * (tr - det_term)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """True where score is the strict max of its 3x3 neighborhood
    (libfast fast_nonmax_3x3 analog, Features/SVOextractor.cpp:108)."""
    neighborhood_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return score >= neighborhood_max


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set (level-0 pixel coords)."""

    uv: jnp.ndarray       # (N, 2) float32 — (u=x, v=y) at level 0
    level: jnp.ndarray    # (N,) int32 pyramid level
    score: jnp.ndarray    # (N,) float32 Shi-Tomasi response
    valid: jnp.ndarray    # (N,) bool


def masked_score_map(img, fast_threshold, use_fast_gate: bool = True):
    """Per-level detector score maps: (masked, raw).

    masked: Shi-Tomasi where the pixel is a FAST corner winning its 3x3
    neighborhood, -inf elsewhere. raw: the dense Shi-Tomasi surface (for
    subpixel refinement).

    Written as one chain of static zero-filled shifts over the level, which
    XLA fuses into a handful of kernels; on an H100 this beats both the
    composition in masked_score_map_reference and a hand-written Triton
    kernel (PERF.md, Findings). The 16 brighter/darker ring flags are
    bit-packed into one int32, so the contiguous-arc test is 16
    shift+compares. Same decisions as the reference everywhere outside the
    3-px border that both mask out.
    """
    img = img.astype(jnp.float32)
    h, w = img.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)

    # --- Shi-Tomasi min-eigenvalue score (zero-padded, SVO normalization) ---
    dx = jnp.where((col >= 1) & (col < w - 1),
                   _shift2d(img, 0, 1) - _shift2d(img, 0, -1), 0.0)
    dy = jnp.where((row >= 1) & (row < h - 1),
                   _shift2d(img, 1, 0) - _shift2d(img, -1, 0), 0.0)

    def box_sum(a):
        acc_h = a
        for s in range(1, ST_RADIUS + 1):
            acc_h = acc_h + _shift2d(a, 0, s) + _shift2d(a, 0, -s)
        acc = acc_h
        for s in range(1, ST_RADIUS + 1):
            acc = acc + _shift2d(acc_h, s, 0) + _shift2d(acc_h, -s, 0)
        return acc

    inv = 1.0 / (2.0 * float((2 * ST_RADIUS + 1) ** 2))
    dxx = box_sum(dx * dx) * inv
    dyy = box_sum(dy * dy) * inv
    dxy = box_sum(dx * dy) * inv
    det_term = jnp.sqrt(jnp.maximum((dxx - dyy) ** 2 + 4.0 * dxy * dxy, 0.0))
    score = 0.5 * (dxx + dyy - det_term)

    # --- FAST-10 segment test, bit-packed ---------------------------------
    if use_fast_gate:
        bmask = jnp.zeros((h, w), jnp.int32)
        dmask = jnp.zeros((h, w), jnp.int32)
        for k, (rdx, rdy) in enumerate(FAST_RING):
            # ring[k][y, x] = img[y + rdy, x + rdx]; the zero fill only
            # reaches the masked 3-px border
            rk = _shift2d(img, int(rdy), int(rdx))
            bmask = bmask | jnp.where(rk > img + fast_threshold, 1 << k, 0)
            dmask = dmask | jnp.where(rk < img - fast_threshold, 1 << k, 0)
        window = (1 << FAST_ARC) - 1
        bext = bmask | (bmask << 16)  # wrap-around: duplicate the 16 bits
        dext = dmask | (dmask << 16)
        corner = jnp.zeros((h, w), bool)
        for s in range(16):
            corner = (corner | (((bext >> s) & window) == window)
                      | (((dext >> s) & window) == window))
        corner = corner & (row >= 3) & (row < h - 3) & (col >= 3) & (col < w - 3)
    else:
        corner = jnp.ones((h, w), bool)  # GFTT: rank every pixel

    # --- 3x3 NMS over corner pixels (self included, >= as in nms3x3) ------
    corner_score = jnp.where(corner, score, -jnp.inf)
    nbmax = corner_score
    for ndy in (-1, 0, 1):
        for ndx in (-1, 0, 1):
            if ndy or ndx:
                nbmax = jnp.maximum(
                    nbmax, _shift2d(corner_score, ndy, ndx, -jnp.inf))
    keep = corner & (corner_score >= nbmax)
    return jnp.where(keep, score, -jnp.inf), score


def masked_score_map_reference(img, fast_threshold,
                               use_fast_gate: bool = True):
    """masked_score_map as the composition of fast_corner_mask,
    shi_tomasi_map and nms3x3 (the reference the tests hold it to)."""
    if use_fast_gate:
        corners = fast_corner_mask(img, fast_threshold)
    else:
        # GFTT-style: every pixel is a candidate, ranked by Shi-Tomasi
        corners = jnp.ones_like(img, dtype=bool)
    score = shi_tomasi_map(img)
    # NMS among corner pixels only (libfast's nonmax runs on the corner
    # list, not the dense field): mask non-corners to -inf first.
    corner_score = jnp.where(corners, score, -jnp.inf)
    keep = corners & nms3x3(corner_score)
    return jnp.where(keep, score, -jnp.inf), score


def _parabola_offset(s_minus: jnp.ndarray, s_center: jnp.ndarray,
                     s_plus: jnp.ndarray) -> jnp.ndarray:
    """1-D quadratic-peak offset in [-0.5, 0.5] from three samples."""
    denom = s_minus + s_plus - 2.0 * s_center
    off = jnp.where(jnp.abs(denom) > 1e-12,
                    0.5 * (s_minus - s_plus) / denom, 0.0)
    return jnp.clip(off, -0.5, 0.5)


def detect_keypoints(
    pyramid: List[jnp.ndarray],
    num_features: int,
    cell_size: int,
    fast_threshold,      # float or traced scalar (adaptive mode varies it)
    min_response: float,
    min_border: int,
    use_fast_gate: bool = True,   # False -> pure Shi-Tomasi (GFTT-style)
    subpixel: bool = False,
    response: str = "fast_st",    # 'fast_st' | 'star' | 'dog' | 'hessian'
) -> Keypoints:
    """Multi-level FAST detection with best-per-cell grid NMS into N slots.

    Mirrors SVOextractor::detect (Features/SVOextractor.cpp:79-133): per level,
    FAST-10 + 3x3 NMS + Shi-Tomasi; one winner per `cell_size` grid cell across
    all levels; final response gate `min_response`.

    `subpixel=True` (beyond the reference, which emits integer grid corners)
    refines each winner by a separable 3-point quadratic fit on the dense
    Shi-Tomasi surface — at 320x240-class resolutions the +-0.5 px
    quantization is the dominant landmark-observation error (~0.5 cm at 2 m).
    """
    h0, w0 = pyramid[0].shape
    grid_rows = h0 // cell_size
    grid_cols = w0 // cell_size
    n_cells = grid_rows * grid_cols

    best_score = jnp.full((n_cells,), -jnp.inf, dtype=jnp.float32)
    best_u = jnp.zeros((n_cells,), dtype=jnp.float32)
    best_v = jnp.zeros((n_cells,), dtype=jnp.float32)
    best_level = jnp.zeros((n_cells,), dtype=jnp.int32)

    raw_maps = []
    for lvl, img in enumerate(pyramid):
        scale = 1 << lvl
        cell_l = cell_size // scale
        if cell_l < 1:
            break
        h, w = img.shape
        if response == "fast_st":
            score, raw = masked_score_map(img, fast_threshold,
                                          use_fast_gate=use_fast_gate)
        else:
            score, raw = response_masked_score(img, response)
        raw_maps.append(raw)
        # border gate in level-0 coordinates
        yy = jnp.arange(h, dtype=jnp.float32)[:, None] * scale
        xx = jnp.arange(w, dtype=jnp.float32)[None, :] * scale
        inb = (
            (xx >= min_border)
            & (xx < w0 - min_border)
            & (yy >= min_border)
            & (yy < h0 - min_border)
        )
        masked = jnp.where(inb, score, -jnp.inf)

        # best per (cell_l x cell_l) cell — crop to the cell-aligned region
        hc, wc = grid_rows * cell_l, grid_cols * cell_l
        tiles = masked[:hc, :wc].reshape(grid_rows, cell_l, grid_cols, cell_l)
        tiles = tiles.transpose(0, 2, 1, 3).reshape(n_cells, cell_l * cell_l)
        cell_max = tiles.max(axis=-1)
        cell_arg = tiles.argmax(axis=-1).astype(jnp.int32)
        py = cell_arg // cell_l
        px = cell_arg % cell_l
        cell_row = jnp.arange(n_cells, dtype=jnp.int32) // grid_cols
        cell_col = jnp.arange(n_cells, dtype=jnp.int32) % grid_cols
        u = ((cell_col * cell_l + px) * scale).astype(jnp.float32)
        v = ((cell_row * cell_l + py) * scale).astype(jnp.float32)

        better = cell_max > best_score
        best_score = jnp.where(better, cell_max, best_score)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)
        best_level = jnp.where(better, lvl, best_level)

    valid_cell = best_score > min_response  # Features/SVOextractor.cpp:128
    sel_scores = jnp.where(valid_cell, best_score, -jnp.inf)

    k = min(num_features, n_cells)
    top_scores, top_idx = jax.lax.top_k(sel_scores, k)
    uv = jnp.stack([best_u[top_idx], best_v[top_idx]], axis=-1)
    level = best_level[top_idx]
    valid = jnp.isfinite(top_scores) & (top_scores > min_response)

    if subpixel:
        du = jnp.zeros((k,), jnp.float32)
        dv = jnp.zeros((k,), jnp.float32)
        for lvl, raw in enumerate(raw_maps):
            scale = 1 << lvl
            h, w = raw.shape
            ul = jnp.clip((uv[:, 0] / scale).astype(jnp.int32), 0, w - 1)
            vl = jnp.clip((uv[:, 1] / scale).astype(jnp.int32), 0, h - 1)
            um = jnp.maximum(ul - 1, 0)
            up = jnp.minimum(ul + 1, w - 1)
            vm = jnp.maximum(vl - 1, 0)
            vp = jnp.minimum(vl + 1, h - 1)
            ox = _parabola_offset(raw[vl, um], raw[vl, ul], raw[vl, up])
            oy = _parabola_offset(raw[vm, ul], raw[vl, ul], raw[vp, ul])
            on = level == lvl
            du = jnp.where(on, ox * scale, du)
            dv = jnp.where(on, oy * scale, dv)
        uv = uv + jnp.stack([du, dv], axis=-1)

    if k < num_features:  # pad to the fixed budget
        pad = num_features - k
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), jnp.float32)])
        level = jnp.concatenate([level, jnp.zeros((pad,), jnp.int32)])
        top_scores = jnp.concatenate([top_scores, jnp.full((pad,), -jnp.inf)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])

    return Keypoints(uv=uv, level=level, score=jnp.where(valid, top_scores, 0.0), valid=valid)


def level_quotas(num_features: int, levels: int, scale_factor: float,
                 cell_size: int, shapes) -> List[int]:
    """Per-level feature allocation, geometric in 1/scale_factor
    (ORBextractor's constructor allocation, Features/ORBextractor.cpp:347-419:
    nfeatures * (1-q)/(1-q^L) * q^l with q = 1/f), capped by each level's
    grid-cell count, remainder pushed to level 0."""
    q = 1.0 / scale_factor
    norm = num_features * (1.0 - q) / (1.0 - q**levels)
    quotas = [int(round(norm * q**lvl)) for lvl in range(levels)]
    caps = [(h // cell_size) * (w // cell_size) for h, w in shapes]
    for lvl in range(levels - 1, 0, -1):
        quotas[lvl] = min(quotas[lvl], caps[lvl])
    # exact budget: level 0 absorbs caps + rounding drift (slots beyond its
    # own cell count simply pad invalid)
    quotas[0] = num_features - sum(quotas[1:])
    return quotas


def detect_keypoints_level(
    img: jnp.ndarray,
    quota: int,
    cell_size: int,
    fast_threshold,
    min_response: float,
    min_border: int,
    use_fast_gate: bool = True,
    response: str = "fast_st",
    subpixel: bool = False,
) -> Keypoints:
    """Single-pyramid-level detection into a fixed `quota` budget, in LEVEL
    pixel coordinates (the multi-scale ORB path detects per level with a
    per-level allocation + per-cell spatial balancing — the grid best-per-cell
    reduction plays DistributeOctTree's role,
    Features/ORBextractor.cpp:421-611). `subpixel` refines winners by the
    same 3-point quadratic fit as detect_keypoints."""
    h, w = img.shape
    if response == "fast_st":
        score, raw = masked_score_map(img, fast_threshold,
                                      use_fast_gate=use_fast_gate)
    else:
        score, raw = response_masked_score(img, response)
    yy = jnp.arange(h, dtype=jnp.float32)[:, None]
    xx = jnp.arange(w, dtype=jnp.float32)[None, :]
    inb = ((xx >= min_border) & (xx < w - min_border)
           & (yy >= min_border) & (yy < h - min_border))
    masked = jnp.where(inb, score, -jnp.inf)

    grid_rows, grid_cols = h // cell_size, w // cell_size
    n_cells = grid_rows * grid_cols
    hc, wc = grid_rows * cell_size, grid_cols * cell_size
    tiles = masked[:hc, :wc].reshape(grid_rows, cell_size, grid_cols, cell_size)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(n_cells, cell_size * cell_size)
    cell_max = tiles.max(axis=-1)
    cell_arg = tiles.argmax(axis=-1).astype(jnp.int32)
    py = cell_arg // cell_size
    px = cell_arg % cell_size
    cell_row = jnp.arange(n_cells, dtype=jnp.int32) // grid_cols
    cell_col = jnp.arange(n_cells, dtype=jnp.int32) % grid_cols
    u = (cell_col * cell_size + px).astype(jnp.float32)
    v = (cell_row * cell_size + py).astype(jnp.float32)

    k = min(quota, n_cells)
    top_scores, top_idx = jax.lax.top_k(cell_max, k)
    uv = jnp.stack([u[top_idx], v[top_idx]], axis=-1)
    valid = jnp.isfinite(top_scores) & (top_scores > min_response)
    if subpixel:
        ui = jnp.clip(uv[:, 0].astype(jnp.int32), 0, w - 1)
        vi = jnp.clip(uv[:, 1].astype(jnp.int32), 0, h - 1)
        um, up = jnp.maximum(ui - 1, 0), jnp.minimum(ui + 1, w - 1)
        vm, vp = jnp.maximum(vi - 1, 0), jnp.minimum(vi + 1, h - 1)
        ox = _parabola_offset(raw[vi, um], raw[vi, ui], raw[vi, up])
        oy = _parabola_offset(raw[vm, ui], raw[vi, ui], raw[vp, ui])
        uv = uv + jnp.stack([ox, oy], axis=-1)
    if k < quota:
        pad = quota - k
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), jnp.float32)])
        top_scores = jnp.concatenate([top_scores, jnp.full((pad,), -jnp.inf)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return Keypoints(
        uv=uv,
        level=jnp.zeros((quota,), jnp.int32),
        score=jnp.where(valid, top_scores, 0.0),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Alternative detector response maps (Extractor factory parity,
# Features/Extractor.h:13-26: STAR, SURF, SIFT detector variants)
# ---------------------------------------------------------------------------
# Each produces a dense per-level response whose local maxima feed the same
# grid NMS / top-N budget as the FAST/Shi-Tomasi path. XLA-only: these are
# selectable alternatives, not the live hot path.


def star_response_map(img: jnp.ndarray, inner: int = 2,
                      outer: int = 4) -> jnp.ndarray:
    """CenSurE/STAR-style center-surround response: |mean(inner box) -
    mean(surrounding ring)| (OpenCV StarDetector's bi-level filter,
    approximated with axis-aligned boxes instead of star shapes)."""
    a_in = float((2 * inner + 1) ** 2)
    a_out = float((2 * outer + 1) ** 2)
    s_in = image_ops.box_filter_sum(img, inner)
    s_out = image_ops.box_filter_sum(img, outer)
    ring = (s_out - s_in) / (a_out - a_in)
    return jnp.abs(s_in / a_in - ring)


def dog_response_map(img: jnp.ndarray, sigma: float = 1.2,
                     k: float = 1.6) -> jnp.ndarray:
    """SIFT-style difference-of-Gaussians magnitude (the pyramid provides the
    octave axis; this is the intra-octave response)."""
    r1 = max(1, int(3 * sigma))
    r2 = max(1, int(3 * sigma * k))
    g1 = image_ops.gaussian_blur(img, sigma=sigma, radius=r1)
    g2 = image_ops.gaussian_blur(img, sigma=sigma * k, radius=r2)
    return jnp.abs(g1 - g2)


def hessian_response_map(img: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """SURF-style box-filter Hessian determinant: Dxx*Dyy - (0.9*Dxy)^2 on a
    box-smoothed image."""
    s = image_ops.box_filter_sum(img, radius) / float((2 * radius + 1) ** 2)
    dxx = _shift2d(s, 0, 2) - 2.0 * s + _shift2d(s, 0, -2)
    dyy = _shift2d(s, 2, 0) - 2.0 * s + _shift2d(s, -2, 0)
    dxy = 0.25 * (_shift2d(s, 1, 1) - _shift2d(s, 1, -1)
                  - _shift2d(s, -1, 1) + _shift2d(s, -1, -1))
    return jnp.maximum(dxx * dyy - (0.9 * dxy) ** 2, 0.0)


def _shift2d(a: jnp.ndarray, dy: int, dx: int, fill=0.0) -> jnp.ndarray:
    """b[y, x] = a[y+dy, x+dx], `fill` outside (static slices, which XLA
    fuses into the consumer)."""
    h, w = a.shape
    if dy > 0:
        a = jnp.concatenate([a[dy:], jnp.full((dy, w), fill, a.dtype)], 0)
    elif dy < 0:
        a = jnp.concatenate([jnp.full((-dy, w), fill, a.dtype), a[:dy]], 0)
    if dx > 0:
        a = jnp.concatenate([a[:, dx:], jnp.full((h, dx), fill, a.dtype)], 1)
    elif dx < 0:
        a = jnp.concatenate([jnp.full((h, -dx), fill, a.dtype), a[:, :dx]], 1)
    return a


RESPONSE_MAPS = {
    "star": star_response_map,
    "dog": dog_response_map,
    "hessian": hessian_response_map,
}


def response_masked_score(img: jnp.ndarray, response: str):
    """Masked score map for an alternative response: dense response + 3x3
    NMS (the FAST/Shi-Tomasi path uses masked_score_map instead)."""
    score = RESPONSE_MAPS[response](img)
    keep = nms3x3(score)
    return jnp.where(keep, score, -jnp.inf), score
