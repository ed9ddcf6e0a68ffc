"""Trajectory evaluation (``eval/``): ATE, RPE, trajectory loaders."""

from .trajectory import (  # noqa: F401
    Trajectory,
    absolute_trajectory_error,
    associate,
    load_kaist_global_pose,
    load_tum,
    relative_pose_error,
    umeyama_alignment,
)
