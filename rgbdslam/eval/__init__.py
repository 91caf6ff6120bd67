from rgbdslam.eval.ate import ate_rmse, align_umeyama, rpe  # noqa: F401
