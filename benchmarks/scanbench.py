"""Scan-based microbench: per-iteration cost of hot-path variants.

Each variant runs inside a 32-trip lax.scan so host dispatch amortizes;
cost = (t_variant - t_empty) per trip.
"""
import time, sys
import numpy as np
import jax, jax.numpy as jnp

import rgbdslam  # noqa
from rgbdslam.config import SlamConfig
from rgbdslam.frontend.frame import build_frame_features
from rgbdslam.frontend.matcher import gather_matched_points, match_frames
from rgbdslam.geometry.camera import SYNTHETIC
from rgbdslam.io.synthetic import SyntheticDataset
from rgbdslam.solvers.ransac_se3 import ransac_se3
from rgbdslam.solvers.icp import gicp_refine
from rgbdslam.ops.orb import _pattern_selectors, extract_patches, _pack_bits

from rgbdslam.utils.compile_cache import enable_compile_cache

enable_compile_cache()

cfg = SlamConfig()
cam = SYNTHETIC
ds = SyntheticDataset(n_frames=4, cam=cam, trajectory="sweep")
frames = [ds.grab(i)[1:] for i in range(len(ds))]
jax.block_until_ready(frames[-1])
gray, depth = frames[0]

TRIPS = 32
N, P = 1024, 31
HALF = P // 2
h, w = gray.shape
rng = np.random.default_rng(0)
uv0 = jnp.asarray(
    np.stack([rng.integers(HALF, w - HALF, N), rng.integers(HALF, h - HALF, N)], -1)
).astype(jnp.float32)


def scan_time(body, init, label, n=8, base=0.0):
    """Times `body` inside a TRIPS-long scan; prints raw ms/trip and, when a
    baseline is given, the baseline-corrected cost (raw - empty-scan cost)."""

    @jax.jit
    def run(c0):
        c, _ = jax.lax.scan(body, c0, None, length=TRIPS)
        return c

    o = run(init); jax.block_until_ready(o)
    t0 = time.perf_counter()
    for _ in range(n):
        o = run(o)
    jax.block_until_ready(o)
    dt = (time.perf_counter() - t0) / (n * TRIPS) * 1e3
    corrected = f"  ({dt - base:8.4f} ms corrected)" if base else ""
    print(f"{label:44s} {dt:8.4f} ms/trip{corrected}", file=sys.stderr)
    return dt


# empty baseline: perturb uv so nothing folds
def empty_body(uvc, _):
    return uvc + 1e-6, None

base = scan_time(empty_body, uv0, "empty scan")


# ---- BRIEF variants ----
sel_a_np, sel_b_np = _pattern_selectors(P)
sel_a, sel_b = jnp.asarray(sel_a_np), jnp.asarray(sel_b_np)


def brief_body_full(uvc, _):
    flat = extract_patches(gray, uvc, P)
    d = _pack_bits((flat @ sel_a) < (flat @ sel_b))
    return uvc + (d[0, 0] % 2).astype(jnp.float32) * 1e-6, None

scan_time(brief_body_full, uv0, "BRIEF full-width band (current)", base=base)


def make_brief_win(WIN):
    def body(uvc, _):
        padded = jnp.pad(gray, HALF, mode="edge")
        u = jnp.clip(jnp.round(uvc[:, 0]).astype(jnp.int32), 0, w - 1)
        v = jnp.clip(jnp.round(uvc[:, 1]).astype(jnp.int32), 0, h - 1)
        start = jnp.clip(u - (WIN - P) // 2, 0, w + P - 1 - WIN)
        bands = jax.vmap(
            lambda vi, si: jax.lax.dynamic_slice(padded, (vi, si), (P, WIN))
        )(v, start)
        off = u - start
        cols = jax.lax.broadcasted_iota(jnp.int32, (1, WIN, P), 1)
        sel = (cols == (off[:, None, None] +
                        jax.lax.broadcasted_iota(jnp.int32, (1, WIN, P), 2))
               ).astype(gray.dtype)
        patches = jnp.einsum("nrw,nwj->nrj", bands, sel,
                             preferred_element_type=jnp.float32)
        flat = patches.reshape(N, -1)
        d = _pack_bits((flat @ sel_a) < (flat @ sel_b))
        return uvc + (d[0, 0] % 2).astype(jnp.float32) * 1e-6, None
    return body

for WIN in (64, 128):
    scan_time(make_brief_win(WIN), uv0, f"BRIEF window-{WIN} band", base=base)


def brief_body_dslice(uvc, _):
    padded = jnp.pad(gray, HALF, mode="edge")
    u = jnp.clip(jnp.round(uvc[:, 0]).astype(jnp.int32), 0, w - 1)
    v = jnp.clip(jnp.round(uvc[:, 1]).astype(jnp.int32), 0, h - 1)
    patches = jax.vmap(
        lambda vi, ui: jax.lax.dynamic_slice(padded, (vi, ui), (P, P))
    )(v, u)
    flat = patches.reshape(N, -1)
    d = _pack_bits((flat @ sel_a) < (flat @ sel_b))
    return uvc + (d[0, 0] % 2).astype(jnp.float32) * 1e-6, None

scan_time(brief_body_dslice, uv0, "BRIEF direct 31x31 dslice", base=base)

# ---- RANSAC / GICP at different pair budgets ----
f0 = build_frame_features(cam, *frames[0], cfg.extractor)
f1 = build_frame_features(cam, *frames[1], cfg.extractor)
m = jax.jit(match_frames, static_argnums=())(f0, f1, cfg.matcher.nn_ratio)
p1, p2, wgt, valid = jax.jit(gather_matched_points)(f0, f1, m)
jax.block_until_ready(valid)
print(f"nvalid={int(valid.sum())}", file=sys.stderr)
key0 = jax.random.PRNGKey(0)

order = jnp.argsort(~valid)  # valid first


def make_ransac_body(M):
    idx = order[:M]
    q1, q2, qw, qv = p1[idx], p2[idx], wgt[idx], valid[idx]

    def body(carry, _):
        k, acc = carry
        k, sub = jax.random.split(k)
        res = ransac_se3(q1, q2, qw, qv + (acc * 0).astype(bool), sub, cfg.ransac)
        return (k, acc + res.rmse * 1e-9), None
    return body

for M in (1024, 512, 256):
    scan_time(make_ransac_body(M), (key0, jnp.float32(0)), f"RANSAC pairs={M}", base=base)


def make_gicp_body(M):
    idx = order[:M]
    q1, q2, qv = p1[idx], p2[idx], valid[idx]
    C1 = f0.surf_cov[idx]
    C2 = f1.surf_cov[m.idx2[idx]]
    T0 = jnp.eye(4, dtype=jnp.float32)

    def body(acc, _):
        T, conv, _n = gicp_refine(q1, q2, qv, T0 + acc * 0, None, cfg.icp,
                                  C1=C1, C2=C2)
        return acc + T * 1e-9, None
    return body

for M in (1024, 512, 256):
    scan_time(make_gicp_body(M), jnp.zeros((4, 4), jnp.float32), f"GICP pairs={M}", base=base)

# ---- full frame-feature build (detect+BRIEF+aux) for reference ----
def feat_body(acc, _):
    f = build_frame_features(cam, gray + acc * 0, depth, cfg.extractor)
    return acc + f.xyz[0, 0] * 1e-12, None

scan_time(feat_body, jnp.float32(0), "build_frame_features (detect+desc+aux)", base=base)
