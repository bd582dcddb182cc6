"""Geometry ops of the port. `furthest_point_sample` and `fused_cbn_decode`
launch hand-written CUDA kernels on CUDA tensors, as do `fusion.render_depth`
and `fusion.tsdf_fuse` (the offline preparation's); the rest is plain
torch."""

from .ball_query import ball_query
from .boxes import (
    aabb_pairwise_iou,
    class2angle,
    class2size,
    corners_to_aabb,
    flip_axis_to_camera,
    flip_axis_to_depth,
    get_3d_box_batch,
)
from .cbn_decoder import fold_cbn_constants, fused_cbn_decode
from .fps import furthest_point_sample
from .grouping import gather_points, group_points, query_and_group
from .interpolate import interpolate_features, three_interpolate, three_nn
from .nms import nms_3d

__all__ = [
    "aabb_pairwise_iou",
    "ball_query",
    "class2angle",
    "class2size",
    "corners_to_aabb",
    "flip_axis_to_camera",
    "flip_axis_to_depth",
    "fold_cbn_constants",
    "furthest_point_sample",
    "fused_cbn_decode",
    "gather_points",
    "get_3d_box_batch",
    "group_points",
    "interpolate_features",
    "nms_3d",
    "query_and_group",
    "three_interpolate",
    "three_nn",
]
