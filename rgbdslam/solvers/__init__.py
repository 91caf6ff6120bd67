from rgbdslam.solvers.kabsch import weighted_rigid_transform  # noqa: F401
from rgbdslam.solvers.ransac_se3 import RansacResult, ransac_se3  # noqa: F401
