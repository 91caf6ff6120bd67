"""Per-frame feature extraction into a fixed-shape device pytree.

Array-program Frame construction (Core/Frame.cpp:34-122): grayscale conversion &
depth scaling happen in the dataset layer; here a single jitted program runs
pyramid -> FAST/Shi-Tomasi grid detection -> (optional) IC orientation ->
BRIEF-256 description -> keypoint undistortion -> depth backprojection, all
under a fixed N-keypoint budget with validity masks (replacing the reference's
dynamic std::vector keypoints + 64x48 hash grid + per-keypoint loops).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from rgbdslam.config import ExtractorConfig
from rgbdslam.geometry import camera as cam_mod
from rgbdslam.geometry.camera import Camera
from rgbdslam.ops import fast as fast_ops
from rgbdslam.ops import image as image_ops
from rgbdslam.ops import orb as orb_ops
from rgbdslam.utils import pytree


@pytree.dataclass
class FrameFeatures:
    """Fixed-budget per-frame features (the device-side Frame).

    Replaces Core/Frame.h:24-216's feature members: mvKeys/mvKeysUn ->
    uv/uv_undist, mvKeys3Dc -> xyz, mDescriptors -> desc, inlier/outlier and
    depth-validity flags -> masks.
    """

    uv: jnp.ndarray          # (N, 2) f32 detected (distorted) pixel coords
    uv_undist: jnp.ndarray   # (N, 2) f32 undistorted pixel coords
    xyz: jnp.ndarray         # (N, 3) f32 camera-frame 3D (z=0 when no depth)
    desc: jnp.ndarray        # (N, 8) u32 packed 256-bit descriptors
    score: jnp.ndarray       # (N,) f32 detector response
    level: jnp.ndarray       # (N,) i32 pyramid level
    valid: jnp.ndarray       # (N,) bool detected slot
    has_depth: jnp.ndarray   # (N,) bool valid metric depth at the keypoint
    intensity: jnp.ndarray   # (N,) f32 gray value (landmark "color",
                             #   Core/Frame.cpp:91-117 stores per-keypoint color)
    smooth: jnp.ndarray      # (N,) bool depth locally smooth (not an
                             #   occlusion boundary) — gate for landmark
                             #   tracks: depth at an edge corner flips
                             #   between fore/background across views and
                             #   poisons bundle adjustment
    surf_cov: jnp.ndarray    # (N, 3, 3) local surface covariance from the
                             #   depth-image patch (plane-to-plane GICP
                             #   weighting without the O(N^2) sparse-set kNN;
                             #   SURVEY.md §7 design stance)

    @property
    def num_slots(self) -> int:
        return self.uv.shape[0]

    @property
    def obs_valid(self) -> jnp.ndarray:
        """Usable observation: detected and has depth (Frame::isValidObs)."""
        return self.valid & self.has_depth


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 6, 7, 8))
def build_frame_features(
    cam: Camera,
    gray: jnp.ndarray,
    depth: jnp.ndarray,
    cfg: ExtractorConfig = ExtractorConfig(),
    use_orientation: bool = False,
    fast_threshold=None,
    use_fast_gate: bool = True,
    descriptor: str = "brief",
    response: str = "fast_st",
) -> FrameFeatures:
    """gray [H,W] f32 (0..255), depth [H,W] f32 meters -> FrameFeatures.

    Mirrors the frame-ingestion call stack (SURVEY.md §3.1) minus disk IO.
    `fast_threshold` may be a traced scalar override (adaptive mode varies it
    per frame without recompiling); `use_fast_gate=False` gives the
    GFTT-style pure Shi-Tomasi detector.

    `descriptor`: 'brief' (upright, the live path) | 'orb' (steered; also
    selected by use_orientation) | 'brisk' | 'freak' | 'latch' | 'sift'
    (float, L2-matched). `response`: 'fast_st' | 'star' | 'dog' | 'hessian'
    alternative detector responses (ops/fast.py) — together these cover the
    reference factory's 12 detector/descriptor types
    (Features/Extractor.h:13-26).
    """
    if use_orientation:
        descriptor = "orb"
    thr = (cfg.fast_threshold if fast_threshold is None else fast_threshold)
    # The final response gate scales with the (possibly adapted) FAST
    # threshold: both measure image contrast (FAST linearly, Shi-Tomasi
    # quadratically), and an absolute floor would defeat the ADAPTIVE
    # stack's whole point on low-contrast scenes — the reference's adaptive
    # detectors are plain FAST with NO response gate
    # (Features/DetectorAdjuster.cpp:23-39). At the default threshold the
    # factor is exactly 1 (reference gate semantics,
    # Features/SVOextractor.cpp:128).
    min_response = cfg.min_response
    if response == "fast_st" and use_fast_gate:
        min_response = cfg.min_response * (
            jnp.asarray(thr, jnp.float32) / cfg.fast_threshold) ** 2

    if cfg.scale_factor != 2.0:
        # ORB-SLAM2-class fractional scale space: x`scale_factor` pyramid,
        # per-level feature quotas, per-level detection + description at
        # level resolution, coords scaled back to level 0
        # (Features/ORBextractor.cpp:347-419, 773-797).
        kp, desc = _multiscale_detect_describe(
            gray, cfg, thr, min_response, use_fast_gate, descriptor, response
        )
    else:
        pyramid = image_ops.build_pyramid(gray, cfg.num_levels)
        kp = fast_ops.detect_keypoints(
            pyramid,
            num_features=cfg.num_features,
            cell_size=cfg.cell_size,
            fast_threshold=thr,
            min_response=min_response,
            min_border=cfg.min_border,
            use_fast_gate=use_fast_gate,
            subpixel=cfg.subpixel,
            response=response,
        )
        blurred = image_ops.gaussian_blur(gray, sigma=2.0, radius=3)
        desc = _describe(blurred, gray, kp.uv, cfg, descriptor)

    return _assemble_features(cam, gray, depth, kp, desc)


def _describe(img_blurred, img_raw, uv, cfg: ExtractorConfig,
              descriptor: str):
    """Descriptor dispatch at the given image/coords (shared by the level-0
    and per-pyramid-level paths)."""
    if descriptor == "orb":
        # steered BRIEF via the binned-rotation matmul path (ORB semantics)
        desc, _angles = orb_ops.orb_descriptors_dense(
            img_blurred, img_raw, uv, cfg.brief_patch_size
        )
        return desc
    if descriptor == "brief":
        # upright BRIEF: patch extraction + one-hot matmuls
        return orb_ops.brief_descriptors_dense(img_blurred, uv,
                                               cfg.brief_patch_size)
    if descriptor in ("brisk", "freak"):
        from rgbdslam.ops.descriptors import pattern_descriptors_dense

        return pattern_descriptors_dense(img_blurred, uv, descriptor,
                                         cfg.brief_patch_size)
    if descriptor == "latch":
        from rgbdslam.ops.descriptors import latch_descriptors_dense

        box3 = image_ops.box_filter_sum(img_raw, 1) / 9.0
        return latch_descriptors_dense(box3, uv, cfg.brief_patch_size)
    if descriptor == "sift":
        from rgbdslam.ops.descriptors import sift_descriptors_dense

        return sift_descriptors_dense(img_blurred, uv)
    raise ValueError(f"unknown descriptor {descriptor!r}")


def _multiscale_detect_describe(gray, cfg: ExtractorConfig, thr, min_response,
                                use_fast_gate: bool, descriptor: str,
                                response: str):
    """x`cfg.scale_factor` pyramid with per-level quotas: detect and describe
    each level AT ITS OWN RESOLUTION (per-level orientation + pattern, like
    ORBextractor computing descriptors on the blurred level image), then map
    coordinates to level 0. Total described keypoints = the N budget, so the
    cost matches the single-level path's."""
    from rgbdslam.ops.fast import Keypoints

    pyramid = image_ops.build_scaled_pyramid(gray, cfg.num_levels,
                                             cfg.scale_factor)
    shapes = [p.shape for p in pyramid]
    quotas = fast_ops.level_quotas(cfg.num_features, cfg.num_levels,
                                   cfg.scale_factor, cfg.cell_size, shapes)
    uvs, descs, scores, levels, valids = [], [], [], [], []
    for lvl, img_l in enumerate(pyramid):
        if quotas[lvl] <= 0:
            continue
        kp_l = fast_ops.detect_keypoints_level(
            img_l, quotas[lvl], cfg.cell_size, thr,
            min_response=min_response,
            min_border=max(cfg.min_border, cfg.brief_patch_size // 2 + 1),
            use_fast_gate=use_fast_gate,
            response=response,
            subpixel=cfg.subpixel,
        )
        blurred_l = image_ops.gaussian_blur(img_l, sigma=2.0, radius=3)
        desc_l = _describe(blurred_l, img_l, kp_l.uv, cfg, descriptor)
        scale = jnp.float32(cfg.scale_factor ** lvl)
        uvs.append(kp_l.uv * scale)
        descs.append(desc_l)
        scores.append(kp_l.score)
        levels.append(jnp.full((quotas[lvl],), lvl, jnp.int32))
        valids.append(kp_l.valid)
    kp = Keypoints(
        uv=jnp.concatenate(uvs),
        level=jnp.concatenate(levels),
        score=jnp.concatenate(scores),
        valid=jnp.concatenate(valids),
    )
    return kp, jnp.concatenate(descs)


@jax.jit
def pack_features_for_host(f: FrameFeatures) -> jnp.ndarray:
    """Everything the host-side keyframe store needs, as ONE (N, D) f32 array
    so the device->host copy is a single transfer (each array fetched
    separately is its own blocking copy).

    Layout: [uv_undist(2) | xyz(3) | desc(8 bitcast or 128 float) |
    intensity(1) | obs_valid(1) | smooth(1)]. Binary descriptors are
    bitcast u32->f32 (transfers are bit-exact; the host views them back).
    """
    if f.desc.dtype == jnp.uint32:
        desc_f = jax.lax.bitcast_convert_type(f.desc, jnp.float32)
    else:
        desc_f = f.desc.astype(jnp.float32)
    return jnp.concatenate(
        [
            f.uv_undist,
            f.xyz,
            desc_f,
            f.intensity[:, None],
            f.obs_valid[:, None].astype(jnp.float32),
            f.smooth[:, None].astype(jnp.float32),
        ],
        axis=1,
    )


def pack_features_slim(f: FrameFeatures) -> jnp.ndarray:
    """Descriptor-free host packing, (N, 4): [uv_undist(2) | z(1) |
    4*round(intensity) + obs_valid + 2*smooth (1)].

    The full pack above is ~65 KB/KF at the 1024-feature budget — and the
    descriptors in it are only ever read on host for checkpointing, codebook
    training and map merge (VERDICT r3 item 2: 'descriptors are fetched for
    checkpointing only'). With a loaded vocabulary the backend therefore
    ships this 16 KB layout instead and hydrates descriptor/BoW rows lazily
    from the device-resident bank (SlamSystem.hydrate_host) when one of
    those rare consumers asks. xyz is NOT shipped: the host reconstructs it
    from (uv_undist, z) with the same pinhole unprojection the device used
    (geometry/camera.py:107-114 — RGBDcamera::unproject,
    Core/RGBDcamera.cpp:126-161). intensity rides the flag lane quantized
    to whole gray levels (4*round(i) + flags <= 1023, exact in f32) — its
    only consumer is viz/export color (Landmark::setColor parity)."""
    flags = (4.0 * jnp.round(jnp.clip(f.intensity, 0.0, 255.0))
             + f.obs_valid.astype(jnp.float32)
             + 2.0 * f.smooth.astype(jnp.float32))
    return jnp.concatenate(
        [
            f.uv_undist,
            f.xyz[:, 2:3],
            flags[:, None],
        ],
        axis=1,
    )


def _assemble_features(cam: Camera, gray, depth, kp, desc) -> FrameFeatures:
    """Shared feature-table tail: depth lookup/denoise, smoothness gate,
    undistortion, unprojection, intensity, surface covariances."""
    # Depth lookup at the detected (distorted) coords, like the reference
    # (Core/Frame.cpp:91-117 reads mImDepth at mvKeys); unprojection uses the
    # undistorted coords (Core/Frame.cpp:251-281 + uprojectCamera).
    z_n = image_ops.nearest_sample(depth, kp.uv)
    has_depth = cam_mod.valid_depth(cam, z_n) & kp.valid
    # depth-edge test: 3x3 min/max range around the keypoint
    zmin = jax.lax.reduce_window(depth, jnp.inf, jax.lax.min, (3, 3), (1, 1),
                                 "SAME")
    zmax = jax.lax.reduce_window(depth, -jnp.inf, jax.lax.max, (3, 3), (1, 1),
                                 "SAME")
    zrange = image_ops.nearest_sample(zmax, kp.uv) - image_ops.nearest_sample(
        zmin, kp.uv)
    smooth = has_depth & (zrange <= 0.03 + 0.02 * z_n)
    # depth denoising on smooth surfaces: 3x3 valid-pixel mean (Kinect-class
    # per-pixel depth noise averages down ~3x; edges keep the center pixel —
    # averaging would mix fore/background there)
    valid_px = (depth > 0).astype(depth.dtype)
    zsum = image_ops.box_filter_sum(depth, 1)
    zcnt = image_ops.box_filter_sum(valid_px, 1)
    zmean = zsum / jnp.maximum(zcnt, 1.0)
    z = jnp.where(smooth, image_ops.nearest_sample(zmean, kp.uv), z_n)
    uv_undist = cam_mod.undistort_pixels(cam, kp.uv)
    z_safe = jnp.where(has_depth, z, 0.0)
    xyz = cam_mod.unproject(cam, uv_undist, z_safe)
    intensity = image_ops.nearest_sample(gray, kp.uv)

    from rgbdslam.solvers.icp import depth_patch_covariances

    surf_cov = depth_patch_covariances(cam, depth, kp.uv)

    return FrameFeatures(
        uv=kp.uv,
        uv_undist=uv_undist,
        xyz=xyz,
        desc=desc,
        score=kp.score,
        level=kp.level,
        valid=kp.valid,
        has_depth=has_depth,
        intensity=intensity,
        smooth=smooth,
        surf_cov=surf_cov,
    )
