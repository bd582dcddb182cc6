"""Oriented 3D box IoU via BEV polygon clipping (host-side, numpy).

The port's own copy of `rfdnet_tpu/eval/box_util.py`: Sutherland-Hodgman
polygon clip, convex-hull intersection area, the camera-frame (y-up,
corners 0-3 top / 4-7 bottom) 3D IoU used by the mAP evaluator, and the
camera/depth axis flips. The convex hull is scipy's, imported where it is
used: the demo path needs only the flips.
"""

from __future__ import annotations

import numpy as np


def poly_area(x, y):
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def polygon_clip(subject_polygon, clip_polygon):
    """Clip `subject_polygon` by convex `clip_polygon` (both CCW point
    lists). Returns the vertex list or None if empty."""

    def inside(p, cp1, cp2):
        return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (
            p[0] - cp1[0]
        )

    def intersection(cp1, cp2, s, e):
        dc = [cp1[0] - cp2[0], cp1[1] - cp2[1]]
        dp = [s[0] - e[0], s[1] - e[1]]
        n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
        n2 = s[0] * e[1] - s[1] * e[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        if den == 0.0:
            # degenerate: subject edge collinear with the clip edge
            # (identical/touching boxes): the collinear overlap
            # contributes no unique intersection point, so the edge
            # endpoint is the clip result.
            return [e[0], e[1]]
        n3 = 1.0 / den
        return [(n1 * dp[0] - n2 * dc[0]) * n3, (n1 * dp[1] - n2 * dc[1]) * n3]

    output = list(subject_polygon)
    cp1 = clip_polygon[-1]
    for cp2 in clip_polygon:
        input_list = output
        output = []
        if not input_list:
            return None
        s = input_list[-1]
        for e in input_list:
            if inside(e, cp1, cp2):
                if not inside(s, cp1, cp2):
                    output.append(intersection(cp1, cp2, s, e))
                output.append(e)
            elif inside(s, cp1, cp2):
                output.append(intersection(cp1, cp2, s, e))
            s = e
        cp1 = cp2
        if len(output) == 0:
            return None
    return output


def convex_hull_intersection(p1, p2):
    from scipy.spatial import ConvexHull

    inter_p = polygon_clip(p1, p2)
    if inter_p is not None:
        try:
            hull = ConvexHull(inter_p)
        except Exception:
            # degenerate (collinear / near-zero-area) intersection polygon:
            # zero overlap.
            return None, 0.0
        return inter_p, hull.volume
    return None, 0.0


def box3d_vol(corners):
    a = np.sqrt(np.sum((corners[0, :] - corners[1, :]) ** 2))
    b = np.sqrt(np.sum((corners[1, :] - corners[2, :]) ** 2))
    c = np.sqrt(np.sum((corners[0, :] - corners[4, :]) ** 2))
    return a * b * c


def box3d_iou(corners1, corners2):
    """(8,3) camera-frame corner boxes -> (iou3d, iou_bev)."""
    rect1 = [(corners1[i, 0], corners1[i, 2]) for i in range(3, -1, -1)]
    rect2 = [(corners2[i, 0], corners2[i, 2]) for i in range(3, -1, -1)]
    area1 = poly_area(np.array(rect1)[:, 0], np.array(rect1)[:, 1])
    area2 = poly_area(np.array(rect2)[:, 0], np.array(rect2)[:, 1])
    _, inter_area = convex_hull_intersection(rect1, rect2)
    # clamp: the true intersection is a subset of both rectangles; for
    # (near-)identical boxes the S-H clip emits fp-garbage vertices that
    # inflate the hull
    inter_area = min(inter_area, area1, area2)
    iou_2d = inter_area / (area1 + area2 - inter_area)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = box3d_vol(corners1)
    vol2 = box3d_vol(corners2)
    iou = inter_vol / (vol1 + vol2 - inter_vol)
    return iou, iou_2d


def get_iou_obb(bb1, bb2):
    return box3d_iou(bb1, bb2)[0]


def calc_iou(box_a, box_b):
    """Axis-aligned IoU for 6-d [cx cy cz dx dy dz] boxes."""
    max_a = box_a[0:3] + box_a[3:6] / 2
    max_b = box_b[0:3] + box_b[3:6] / 2
    min_max = np.array([max_a, max_b]).min(0)
    min_a = box_a[0:3] - box_a[3:6] / 2
    min_b = box_b[0:3] - box_b[3:6] / 2
    max_min = np.array([min_a, min_b]).max(0)
    if not ((min_max > max_min).all()):
        return 0.0
    intersection = (min_max - max_min).prod()
    vol_a = box_a[3:6].prod()
    vol_b = box_b[3:6].prod()
    union = vol_a + vol_b - intersection
    return 1.0 * intersection / union


def get_3d_box(box_size, heading_angle, center):
    """(8, 3) camera-frame corners of a box from its size (l, w, h),
    heading angle and center."""
    c, s = np.cos(heading_angle), np.sin(heading_angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    l, w, h = box_size
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = np.dot(R, np.vstack([x, y, z]))
    corners[0, :] += center[0]
    corners[1, :] += center[1]
    corners[2, :] += center[2]
    return corners.T


def flip_axis_to_camera(pc):
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 1] *= -1
    return pc2


def flip_axis_to_depth(pc):
    pc2 = np.copy(pc)
    pc2[..., [0, 1, 2]] = pc2[..., [0, 2, 1]]
    pc2[..., 2] *= -1
    return pc2
