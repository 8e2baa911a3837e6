from tpu_ba_torch.posegraph.solver import solve_pose_graph, pose_graph_cost  # noqa: F401
