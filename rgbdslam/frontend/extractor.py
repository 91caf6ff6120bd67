"""Extractor factory: detector/descriptor variants + ADAPTIVE mode.

Array-program Features/Extractor.{h,cpp}: the reference's factory offers 12
OpenCV detector types and a NORMAL/ADAPTIVE mode switch
(Features/Extractor.h:13-31). As array programs the meaningful axes
collapse to:

- 'svo_fast' (the live path, main.cpp:31): FAST-10 gate + Shi-Tomasi grid
  ranking + upright BRIEF — the default.
- 'orb': same detection with IC-angle orientation + steered BRIEF
  (ORBextractor semantics, Features/ORBextractor.cpp:16-87).
- 'gftt': pure Shi-Tomasi ranking, no FAST gate (GFTT-class detectors).
- 'fast' / 'brief': aliases of the live FAST+BRIEF path.
- 'star': center-surround (CenSurE) response + BRIEF.
- 'brisk' / 'freak' / 'latch': FAST detection + the corresponding binary
  sampling pattern (ops/descriptors.py).
- 'sift': DoG response + 128-D float gradient-histogram descriptor (L2).
- 'surf': box-Hessian response + the same float descriptor (L2).
All twelve reference factory types (Features/Extractor.h:13-26) map onto
these (ORB2's fused detect+describe is the default fusion here; SVO == the
live 'svo_fast').

ADAPTIVE mode replaces the DetectorAdjuster -> VideoDynamic -> VideoGrid
stack (Features/Extractor.cpp:82-109): instead of re-detecting up to 5 times
per frame, the FAST threshold is a *traced* scalar adjusted once per frame
from the previous frame's keypoint count with the reference's x0.7 / x1.3
rule (Features/DetectorAdjuster.cpp:45-57) — video statistics change slowly,
so the persistent-threshold feedback loop converges the same way with zero
extra detection passes (and no recompiles). The per-cell grid quota is
already enforced by detect_keypoints' best-per-cell reduction.
"""

from __future__ import annotations

import jax.numpy as jnp

from rgbdslam.config import ExtractorConfig
from rgbdslam.frontend.frame import FrameFeatures, build_frame_features
from rgbdslam.geometry.camera import Camera


class Extractor:
    # name -> (response, use_fast_gate, descriptor); reference factory table
    # (Features/Extractor.h:13-26; ORB2/SVO/FAST/BRIEF collapse onto the
    # fused live path)
    VARIANTS = {
        "svo_fast": ("fast_st", True, "brief"),
        "fast": ("fast_st", True, "brief"),
        "brief": ("fast_st", True, "brief"),
        "orb": ("fast_st", True, "orb"),
        "orb2": ("fast_st", True, "orb"),
        "gftt": ("fast_st", False, "brief"),
        "star": ("star", False, "brief"),
        "brisk": ("fast_st", True, "brisk"),
        "freak": ("fast_st", True, "freak"),
        "latch": ("fast_st", True, "latch"),
        "sift": ("dog", False, "sift"),
        "surf": ("hessian", False, "sift"),
    }
    DETECTORS = tuple(VARIANTS)
    # response magnitudes differ by orders of magnitude (Shi-Tomasi scores
    # are O(100) on 8-bit images; DoG is a blur difference O(1), Hessian a
    # product of second derivatives): scale the min_response gate per
    # response so one config value works across variants
    RESPONSE_GATE_SCALE = {"fast_st": 1.0, "star": 0.05, "dog": 0.02,
                           "hessian": 0.01}

    def __init__(
        self,
        cam: Camera,
        cfg: ExtractorConfig = ExtractorConfig(),
        detector: str = "svo_fast",
        adaptive: bool = False,
        target_min: int | None = None,   # default: cfg.adapt_target_min
        target_max: int | None = None,   # (Features/Extractor.cpp:95 band)
        th_min: float | None = None,
        th_max: float | None = None,
    ):
        if detector not in self.DETECTORS:
            raise ValueError(f"unknown detector {detector!r}; one of {self.DETECTORS}")
        self.cam = cam
        self.cfg = cfg
        self.detector = detector
        self.adaptive = adaptive
        self.target_min = (cfg.adapt_target_min if target_min is None
                           else target_min)
        self.target_max = (cfg.adapt_target_max if target_max is None
                           else target_max)
        self.th_min = cfg.adapt_th_min if th_min is None else th_min
        self.th_max = cfg.adapt_th_max if th_max is None else th_max
        self.threshold = float(cfg.fast_threshold)

    def _resolved(self):
        """(response, use_fast_gate, descriptor, cfg) with the variant's
        static adjustments applied — all Python-static, safe under trace."""
        import dataclasses

        response, use_fast_gate, descriptor = self.VARIANTS[self.detector]
        cfg = self.cfg
        gate = self.RESPONSE_GATE_SCALE[response]
        if gate != 1.0:
            cfg = dataclasses.replace(cfg,
                                      min_response=cfg.min_response * gate)
        if self.detector in ("orb", "orb2") and cfg.scale_factor == 2.0:
            # ORBextractor scale-space parity: x1.2, 8 levels, per-level
            # quotas (Features/Extractor.cpp:21) — unless the caller pinned
            # a non-default pyramid in the config
            cfg = dataclasses.replace(cfg, scale_factor=1.2, num_levels=8)
        return response, use_fast_gate, descriptor, cfg

    def build(self, gray, depth, threshold) -> FrameFeatures:
        """Pure feature build at a given (possibly traced) threshold —
        callable from inside a larger jitted program (the tracker fuses it
        with matching + RANSAC into one per-frame dispatch)."""
        response, use_fast_gate, descriptor, cfg = self._resolved()
        return build_frame_features(
            self.cam,
            jnp.asarray(gray),
            jnp.asarray(depth),
            cfg,
            fast_threshold=jnp.float32(threshold)
            if not hasattr(threshold, "dtype") else threshold,
            use_fast_gate=use_fast_gate,
            descriptor=descriptor,
            response=response,
        )

    def adapt(self, num_valid: int):
        """DetectorAdjuster::tooFew/tooMany (x0.7 / x1.3, clamped) threshold
        feedback from the previous frame's keypoint count."""
        _, use_fast_gate, _, _ = self._resolved()
        if not (self.adaptive and use_fast_gate):
            return
        if num_valid < self.target_min:
            self.threshold = max(self.threshold * 0.7, self.th_min)
        elif num_valid > self.target_max:
            self.threshold = min(self.threshold * 1.3, self.th_max)

    def __call__(self, gray, depth) -> FrameFeatures:
        f = self.build(gray, depth, self.threshold)
        if not self.adaptive:
            return f
        # within-frame retry loop (<=5 detections,
        # VideoDynamicAdaptedFeatureDetector.cpp:24-44): re-detect at the
        # adjusted threshold until the count enters the band. Only the
        # too-few direction re-runs — the fixed N-slot budget already caps
        # over-detection at the strongest N.
        for _ in range(5):
            before = self.threshold
            n_valid = int(f.valid.sum())   # one device fetch per iteration
            self.adapt(n_valid)
            if n_valid >= self.target_min or self.threshold >= before - 1e-9:
                break
            f = self.build(gray, depth, self.threshold)
        return f
