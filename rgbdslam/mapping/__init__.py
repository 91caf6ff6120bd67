from rgbdslam.mapping.keyframes import KeyframeStore  # noqa: F401
