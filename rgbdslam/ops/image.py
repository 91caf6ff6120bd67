"""Image ops: pyramid, blur, gradients, bilinear sampling.

Array-program equivalents of the OpenCV image plumbing the reference leans on:
half-sampling pyramid (Features/SVOextractor.cpp:16-37,135-144), Gaussian blur
before description (Features/ORBextractor.cpp:746), and the per-keypoint
bilinear reads used by descriptor sampling. Everything is fused elementwise /
reduce-window work that XLA fuses; convolutions are expressed as
separable depthwise convs.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np


def half_sample(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 average downsample (SVO halfSample, Features/SVOextractor.cpp:16-37)."""
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    return x.mean(axis=(1, 3))


def build_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """Half-sampling pyramid (Features/SVOextractor.cpp:135-144)."""
    pyr = [img]
    for _ in range(1, levels):
        pyr.append(half_sample(pyr[-1]))
    return pyr


def scaled_pyramid_shapes(h: int, w: int, levels: int,
                          scale_factor: float) -> List[tuple]:
    """Static per-level (h, w) for a x`scale_factor` pyramid (ORB-SLAM2's
    ComputePyramid rounding: size_l = round(size_0 / f^l),
    Features/ORBextractor.cpp:773-797)."""
    return [
        (max(int(round(h / scale_factor**lvl)), 16),
         max(int(round(w / scale_factor**lvl)), 16))
        for lvl in range(levels)
    ]


def build_scaled_pyramid(img: jnp.ndarray, levels: int,
                         scale_factor: float) -> List[jnp.ndarray]:
    """Fractional-scale pyramid via chained linear resize (the ORBextractor's
    x1.2 / 8-level scale space, Features/ORBextractor.cpp:773-797 — cv::resize
    INTER_LINEAR from the previous level, not from level 0, so blur
    accumulates down the octaves exactly like the reference).

    Shapes are static per (input shape, levels, factor) — one compile."""
    shapes = scaled_pyramid_shapes(img.shape[0], img.shape[1], levels,
                                   scale_factor)
    pyr = [img]
    for lvl in range(1, levels):
        pyr.append(
            jax.image.resize(pyr[-1], shapes[lvl], method="linear")
        )
    return pyr


def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Gaussian blur (ORBextractor blurs 7x7 sigma 2 before describing,
    Features/ORBextractor.cpp:746).

    Implemented as separable shift-and-accumulate over a reflect-padded image
    (static slices fuse into one elementwise loop instead of a 1-channel
    convolution)."""
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    h, w = img.shape
    pad = jnp.pad(img, radius, mode="reflect")
    # horizontal pass
    acc = jnp.zeros_like(img)
    for i, kv in enumerate(k):
        acc = acc + float(kv) * pad[radius : radius + h, i : i + w]
    # vertical pass
    pad2 = jnp.pad(acc, ((radius, radius), (0, 0)), mode="reflect")
    out = jnp.zeros_like(img)
    for i, kv in enumerate(k):
        out = out + float(kv) * pad2[i : i + h, :]
    return out


def sobel_gradients(img: jnp.ndarray):
    """Central-difference gradients matching SVO's Shi-Tomasi gradient
    (dx = I[x+1]-I[x-1], Features/SVOextractor.cpp:63-66)."""
    dx = jnp.zeros_like(img)
    dy = jnp.zeros_like(img)
    dx = dx.at[:, 1:-1].set(img[:, 2:] - img[:, :-2])
    dy = dy.at[1:-1, :].set(img[2:, :] - img[:-2, :])
    return dx, dy


def box_filter_sum(img: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Sum over a (2r+1)^2 window via reduce_window."""
    return jax.lax.reduce_window(
        img,
        0.0,
        jax.lax.add,
        (2 * radius + 1, 2 * radius + 1),
        (1, 1),
        "SAME",
    )


def bilinear_sample(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation at float pixel coords uv (..., 2) = (u=x, v=y).

    Out-of-bounds coordinates are clamped.
    """
    h, w = img.shape
    u = jnp.clip(uv[..., 0], 0.0, w - 1.0)
    v = jnp.clip(uv[..., 1], 0.0, h - 1.0)
    u0 = jnp.minimum(jnp.floor(u).astype(jnp.int32), w - 2)
    v0 = jnp.minimum(jnp.floor(v).astype(jnp.int32), h - 2)
    du = u - u0
    dv = v - v0
    u1 = u0 + 1
    v1 = v0 + 1
    i00 = img[v0, u0]
    i01 = img[v0, u1]
    i10 = img[v1, u0]
    i11 = img[v1, u1]
    return (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )


def nearest_sample(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor read at float pixel coords (clamped)."""
    h, w = img.shape
    u = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, w - 1)
    v = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, h - 1)
    return img[v, u]
