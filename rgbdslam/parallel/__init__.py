from rgbdslam.parallel.dist_ba import (  # noqa: F401
    distributed_pose_graph_optimize,
    make_mesh,
    shard_edges,
)
