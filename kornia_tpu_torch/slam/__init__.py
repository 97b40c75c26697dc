"""SLAM: two-view pose, visual odometry, loop closure and the optimisation back end."""
from .ba import BAProblem, BAState, bundle_adjust, reprojection_residuals
from .ba_sparse import (build_point_tables, bundle_adjust_sparse,
                        gnc_weight_fn)
from .sfm import SfmResult, incremental_sfm
from .posegraph import (PoseGraph, optimize_pose_graph,
                        optimize_pose_graph_sim3)
from .twoview import TwoViewResult, match_pair, two_view_pose
from .loop_closure import (LoopEdge, close_loops, detect_loop_candidates,
                           global_descriptors, verify_loop)
from .vo import VisualOdometry, VOResult
