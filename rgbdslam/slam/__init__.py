from rgbdslam.slam.tracking import Tracker, TrackerState  # noqa: F401
