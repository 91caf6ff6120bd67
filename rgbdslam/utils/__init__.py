from rgbdslam.utils import profiling, serialization  # noqa: F401
