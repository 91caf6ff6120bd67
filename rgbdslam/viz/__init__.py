from rgbdslam.viz.export import (  # noqa: F401
    draw_tracked_points,
    plot_trajectories,
    save_ply,
)
