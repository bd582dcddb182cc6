"""Geometry ops of the reference, plain torch: FPS and the CBN decode as
the plain versions of the port's CUDA kernels, and the rest as the port
computes them."""

from .ball_query import ball_query
from .boxes import (
    class2angle,
    class2size,
    corners_to_aabb,
    flip_axis_to_camera,
    get_3d_box_batch,
)
from .cbn_decoder import fold_cbn_constants, fused_cbn_decode
from .fps import furthest_point_sample
from .grouping import gather_points, group_points, query_and_group
from .interpolate import interpolate_features
from .nms import nms_3d

__all__ = [
    "ball_query",
    "class2angle",
    "class2size",
    "corners_to_aabb",
    "flip_axis_to_camera",
    "fold_cbn_constants",
    "furthest_point_sample",
    "fused_cbn_decode",
    "gather_points",
    "get_3d_box_batch",
    "group_points",
    "interpolate_features",
    "nms_3d",
    "query_and_group",
]
