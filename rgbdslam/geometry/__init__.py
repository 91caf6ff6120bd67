from rgbdslam.geometry import se3, camera  # noqa: F401
from rgbdslam.geometry.camera import Camera, TUM_FR1, TUM_FR2, TUM_FR3, ICL_NUIM, CORBS  # noqa: F401
