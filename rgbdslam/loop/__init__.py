from rgbdslam.loop.codebook import train_codebook, quantize  # noqa: F401
from rgbdslam.loop.bow import bow_vector, bow_scores  # noqa: F401
from rgbdslam.loop.detector import LoopDetector  # noqa: F401
