from rgbdslam.io import datasets, synthetic, trajectory  # noqa: F401
