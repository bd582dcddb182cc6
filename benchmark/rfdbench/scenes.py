"""Synthetic ScanNet-format scenes: the traffic's scans and their GT
fields.

A copy of the port's `data/synthetic.py:synthetic_scene_batch` (itself
the JAX package's generator): point clouds with the height feature, boxes
padded to MAX_NUM_OBJ, per-point votes and instance labels, per-object
occupancy point sets and 16^3 voxels. Each scene is a floor and
`num_objects` box objects of the dataset's classes, so every seed gives
the same sizes; the seed moves the boxes. Kept here so that the traffic
does not change when the port's generator does."""

from __future__ import annotations

import numpy as np

MAX_NUM_OBJ = 64


def synthetic_scene_batch(
    rng: np.random.RandomState,
    batch_size: int = 2,
    num_points: int = 4096,
    num_objects: int = 4,
    num_obj_points: int = 256,
    num_heading_bin: int = 12,
    num_class: int = 8,
    mean_size_arr: np.ndarray | None = None,
    scene_extent: float = 4.0,
) -> dict:
    if mean_size_arr is None:
        mean_size_arr = np.full((num_class, 3), 0.8, dtype=np.float32)

    B = batch_size
    pc = np.zeros((B, num_points, 4), np.float32)
    center_label = np.zeros((B, MAX_NUM_OBJ, 3), np.float32)
    heading_class_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    heading_residual_label = np.zeros((B, MAX_NUM_OBJ), np.float32)
    size_class_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    size_residual_label = np.zeros((B, MAX_NUM_OBJ, 3), np.float32)
    sem_cls_label = np.zeros((B, MAX_NUM_OBJ), np.int32)
    box_label_mask = np.zeros((B, MAX_NUM_OBJ), np.float32)
    vote_label = np.zeros((B, num_points, 9), np.float32)
    vote_label_mask = np.zeros((B, num_points), np.int32)
    point_instance_labels = np.zeros((B, num_points), np.float32)
    object_instance_labels = np.zeros((B, MAX_NUM_OBJ), np.float32)
    object_points = np.zeros((B, MAX_NUM_OBJ, num_obj_points, 3), np.float32)
    object_points_occ = np.zeros((B, MAX_NUM_OBJ, num_obj_points), np.float32)
    # 16^3 canonical voxelization consistent with the occupancy labels
    # below (inside points uniform in [-0.45, 0.45]^3): a cell is occupied
    # iff its center lies in that box
    ax = -0.5 + 1.0 / 32 + np.arange(16) / 16.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    box_voxels = (
        (np.abs(gx) <= 0.45) & (np.abs(gy) <= 0.45) & (np.abs(gz) <= 0.45)
    ).astype(np.float32)
    object_voxels = np.zeros((B, MAX_NUM_OBJ, 16, 16, 16), np.float32)

    for b in range(B):
        n_bg = num_points - num_objects * (num_points // (num_objects + 1))
        per_obj = num_points // (num_objects + 1)
        # floor points
        pts = []
        floor = rng.uniform(-scene_extent, scene_extent, size=(n_bg, 3)).astype(
            np.float32)
        floor[:, 2] = 0.0
        pts.append(floor)
        for o in range(num_objects):
            cls = rng.randint(0, num_class)
            size = mean_size_arr[cls] * rng.uniform(0.7, 1.3, size=3)
            center = rng.uniform(-scene_extent * 0.7, scene_extent * 0.7, size=3)
            center[2] = size[2] / 2 + rng.uniform(0, 0.3)
            heading = rng.uniform(0, 2 * np.pi)
            # surface-ish points of the box (in canonical frame then rotated)
            local = rng.uniform(-0.5, 0.5, size=(per_obj, 3)) * size
            face = rng.randint(0, 3, size=per_obj)
            sgn = rng.choice([-0.5, 0.5], size=per_obj)
            local[np.arange(per_obj), face] = sgn * size[face]
            c, s = np.cos(heading), np.sin(heading)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            world = local @ R.T + center
            pts.append(world.astype(np.float32))

            start = n_bg + o * per_obj
            idx = slice(start, start + per_obj)
            center_label[b, o] = center
            hc, hr = _angle2class(heading, num_heading_bin)
            heading_class_label[b, o] = hc
            heading_residual_label[b, o] = hr
            size_class_label[b, o] = cls
            size_residual_label[b, o] = size - mean_size_arr[cls]
            sem_cls_label[b, o] = cls
            box_label_mask[b, o] = 1.0
            vote = center - world  # (per_obj, 3)
            vote_label[b, idx] = np.tile(vote, (1, 3))
            vote_label_mask[b, idx] = 1
            point_instance_labels[b, idx] = o + 1
            object_instance_labels[b, o] = o + 1

            # occupancy supervision in the padded unit cube (canonical frame)
            n_in = num_obj_points // 2
            p_in = rng.uniform(-0.45, 0.45, size=(n_in, 3)).astype(np.float32)
            p_out = rng.uniform(-0.55, 0.55, size=(num_obj_points - n_in, 3))
            object_points[b, o, :n_in] = p_in
            object_points[b, o, n_in:] = p_out
            object_points_occ[b, o, :n_in] = 1.0
            # outside points in [-0.55, 0.55]^3 may fall inside the box:
            # relabel them so supervision is consistent
            out_in_box = np.all(
                np.abs(object_points[b, o, n_in:]) <= 0.45, axis=-1)
            object_points_occ[b, o, n_in:] = out_in_box.astype(np.float32)
            object_voxels[b, o] = box_voxels

        all_pts = np.concatenate(pts, axis=0)[:num_points]
        pc[b, :, :3] = all_pts
        floor_height = np.percentile(all_pts[:, 2], 0.99)
        pc[b, :, 3] = all_pts[:, 2] - floor_height

    return {
        "point_clouds": pc,
        "center_label": center_label,
        "heading_class_label": heading_class_label,
        "heading_residual_label": heading_residual_label,
        "size_class_label": size_class_label,
        "size_residual_label": size_residual_label,
        "sem_cls_label": sem_cls_label,
        "box_label_mask": box_label_mask,
        "vote_label": vote_label,
        "vote_label_mask": vote_label_mask,
        "point_instance_labels": point_instance_labels,
        "object_instance_labels": object_instance_labels,
        "object_points": object_points,
        "object_points_occ": object_points_occ,
        "object_voxels": object_voxels,
    }


def _angle2class(angle, num_heading_bin):
    angle = angle % (2 * np.pi)
    angle_per_class = 2 * np.pi / num_heading_bin
    shifted = (angle + angle_per_class / 2) % (2 * np.pi)
    class_id = int(shifted / angle_per_class)
    residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
    return class_id, residual
