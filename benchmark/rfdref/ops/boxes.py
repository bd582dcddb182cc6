"""Box geometry: heading/size decoding, corners, frames, AABB IoU.

Counterpart of `rfdnet_tpu/ops/boxes.py`, batched over any leading axes.
"""

from __future__ import annotations

import math

import torch


def class2angle(pred_cls: torch.Tensor, residual: torch.Tensor,
                num_heading_bin: int, to_label_format: bool = True):
    """Heading bin + residual -> angle."""
    angle_per_class = 2.0 * math.pi / float(num_heading_bin)
    angle = pred_cls.float() * angle_per_class + residual
    if to_label_format:
        angle = angle - 2.0 * math.pi * (angle > math.pi).float()
    return angle


def class2size(pred_cls: torch.Tensor, residual: torch.Tensor,
               mean_size_arr: torch.Tensor) -> torch.Tensor:
    """Size cluster + residual -> (l, w, h)."""
    return mean_size_arr[pred_cls.long()] + residual


def flip_axis_to_camera(pc: torch.Tensor) -> torch.Tensor:
    """Depth (X right, Y fwd, Z up) -> camera (X right, Y down, Z fwd)."""
    return torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], dim=-1)


def get_3d_box_batch(box_size: torch.Tensor, heading_angle: torch.Tensor,
                     center: torch.Tensor) -> torch.Tensor:
    """box_size (..., 3) as (l, w, h), heading_angle (...,), center (..., 3)
    camera frame -> (..., 8, 3) corners (0-3 top face, 4-7 bottom)."""
    dev = box_size.device
    sgn_x = torch.tensor([1, 1, -1, -1, 1, 1, -1, -1], dtype=torch.float32,
                         device=dev)
    sgn_y = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], dtype=torch.float32,
                         device=dev)
    sgn_z = torch.tensor([1, -1, -1, 1, 1, -1, -1, 1], dtype=torch.float32,
                         device=dev)
    x = 0.5 * box_size[..., 0:1] * sgn_x
    y = 0.5 * box_size[..., 2:3] * sgn_y
    z = 0.5 * box_size[..., 1:2] * sgn_z
    c = torch.cos(heading_angle)[..., None]
    s = torch.sin(heading_angle)[..., None]
    # roty: [c 0 s; 0 1 0; -s 0 c]
    rx = c * x + s * z
    rz = -s * x + c * z
    corners = torch.stack([rx, y, rz], dim=-1)
    return corners + center[..., None, :]


def corners_to_aabb(corners: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) corners -> (..., 6) [xmin ymin zmin xmax ymax zmax]."""
    return torch.cat([corners.amin(dim=-2), corners.amax(dim=-2)], dim=-1)


def aabb_pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (K, 6) axis-aligned boxes -> (K, K)."""
    mins, maxs = boxes[:, :3], boxes[:, 3:]
    lo = torch.maximum(mins[:, None, :], mins[None, :, :])
    hi = torch.minimum(maxs[:, None, :], maxs[None, :, :])
    inter = torch.clamp(hi - lo, min=0.0).prod(dim=-1)
    vol = (maxs - mins).prod(dim=-1)
    union = vol[:, None] + vol[None, :] - inter
    return inter / torch.clamp(union, min=1e-12)
