from rgbdslam.ops import image, fast, orb, hamming  # noqa: F401
