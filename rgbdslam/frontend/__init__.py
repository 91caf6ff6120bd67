from rgbdslam.frontend.frame import FrameFeatures, build_frame_features  # noqa: F401
from rgbdslam.frontend.matcher import MatchResult, match_frames  # noqa: F401
