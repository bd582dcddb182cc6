"""Test-time mesh-to-scan box refit.

Counterpart of `rfdnet_tpu/eval/refit.py`. For every confident NMS
survivor with a mesh, the mesh's vertices (centered, turned into the scan
frame by the ShapeNet-to-depth axis swap, scaled to unit extents and then
to the predicted box size) are registered against the scene points inside
the 1.2x-enlarged box (floor points below the 5th height percentile left
out): 100 Adam(lr 1e-2) steps on the box centroid and heading minimise the
one-directional chamfer loss (scene -> mesh, x1e3), and the parameters of
the lowest loss win.

The host prepares the point sets; `_optimize` runs the steps for all
proposals at once on the device of the caller's choice, with autograd and
an Adam written out as `optax.adam` computes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.chamfer import squared_distance_to_nearest
from .box_util import flip_axis_to_camera, flip_axis_to_depth, get_3d_box

TRANSFORM_SHAPENET = np.array([[0, 0, -1], [-1, 0, 0], [0, 1, 0]], np.float64)

ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 1e-2, 0.9, 0.999, 1e-8


def _box_params_from_corners(box_corners_cam: np.ndarray) -> np.ndarray:
    """corners (8, 3) camera frame -> [centroid(3), sizes(3), orientation]
    in the depth frame."""
    c = flip_axis_to_depth(box_corners_cam)
    centroid = (c.max(0) + c.min(0)) / 2.0
    forward = c[1] - c[2]
    left = c[0] - c[1]
    up = c[6] - c[2]
    orientation = np.arctan2(forward[1], forward[0])
    sizes = np.linalg.norm(np.stack([forward, left, up]), axis=1)
    return np.concatenate([centroid, sizes, [orientation]])


def _points_in_obb(points: np.ndarray, centroid, sizes, orientation):
    """Scene points inside the oriented box: inverse-rotate and test the
    bounds."""
    c, s = np.cos(orientation), np.sin(orientation)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    local = (points - centroid) @ R
    ok = np.all(np.abs(local) <= np.asarray(sizes) / 2.0 + 1e-9, axis=1)
    return points[ok]


def _refit_loss(obj_points, pc_in_box, pc_mask, centroid, orientation,
                loss_denom, rows: int, queries: int, candidates: int):
    """The chamfer loss of the placed meshes, searched over the first
    `rows` proposals, `queries` scene points and `candidates` mesh points
    (see `_optimize`)."""
    c, s = torch.cos(orientation), torch.sin(orientation)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    # row-vector convention: p @ R
    R = torch.stack([torch.stack([c, s, zeros], -1),
                     torch.stack([-s, c, zeros], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)  # (K, 3, 3)
    placed = torch.einsum("kno,koj->knj", obj_points, R) + centroid[:, None, :]
    dist2 = squared_distance_to_nearest(pc_in_box[:rows, :queries],
                                        placed[:rows, :candidates])
    return torch.sum(dist2 * pc_mask[:rows, :queries]) / loss_denom * 1e3


def _optimize(obj_points, pc_in_box, pc_mask, centroids, orientations,
              loss_denom, iterations: int = 100, rows: int | None = None,
              queries: int | None = None, candidates: int | None = None):
    """The joint refit on the device of the inputs: obj_points (K, No, 3)
    pre-scaled mesh points, pc_in_box (K, Np, 3), pc_mask (K, Np),
    centroids (K, 3), orientations (K,) float32 tensors. Returns the
    (centroids, orientations) of the lowest loss, as tensors.

    `loss_denom` (K_actual x 50000) keeps the loss on the reference's
    normalisation, so the Adam trajectory does not depend on the padding.
    The search leaves out what the padding cannot change: proposals from
    `rows` on and scene points from `queries` on (their `pc_mask` is
    zero), and mesh points from `candidates` on (zero pads that repeat an
    earlier one of every proposal, which the first-index rule never
    picks). Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected, as
    `optax.adam(1e-2)`; a step's parameters become the best when their
    loss is strictly below the best so far."""
    K, No = obj_points.shape[:2]
    bounds = (K if rows is None else rows,
              pc_in_box.shape[1] if queries is None else queries,
              No if candidates is None else candidates)
    params = [centroids.clone(), orientations.clone()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    best = [p.clone() for p in params]
    best_loss = torch.tensor(math.inf, device=centroids.device)
    one = torch.ones((), dtype=torch.float32, device=centroids.device)
    for step in range(1, iterations + 1):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = _refit_loss(obj_points, pc_in_box, pc_mask, *leaves,
                               loss_denom, *bounds)
            grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        improved = loss < best_loss
        best = [torch.where(improved, p, b) for p, b in zip(params, best)]
        best_loss = torch.minimum(best_loss, loss)
        # optax: 1 - decay**count in float32, then the moments divided
        corr1 = 1 - (ADAM_B1 * one) ** step
        corr2 = 1 - (ADAM_B2 * one) ** step
        for i, g in enumerate(grads):
            mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * mu[i]
            nu[i] = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu[i]
            update = (mu[i] / corr1) / (torch.sqrt(nu[i] / corr2) + ADAM_EPS)
            params[i] = params[i] + (-ADAM_LR) * update
    return best[0], best[1]


def _pow2(n, lo, hi):
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def fit_meshes_to_scan(parsed_predictions: dict, meshes: list,
                       proposal_ids: np.ndarray, valid: np.ndarray,
                       point_clouds: np.ndarray, dump_threshold: float,
                       max_obj_points: int = 10_000,
                       max_pc_in_box: int = 50_000,
                       iterations: int = 100, device="cpu",
                       stats: dict | None = None) -> dict:
    """Refit the boxes of batch 0..B-1 on `device`. meshes: flat list of
    TriMesh aligned with proposal_ids.reshape(-1, 3) rows. Writes the
    refit corners into parsed_predictions['pred_corners_3d_upright_camera']
    (a numpy copy) and returns parsed_predictions. `stats`: a dict that
    receives the sizes of the optimisation: `proposals`, and the most
    `mesh_points` and `scene_points` of a proposal."""
    corners_all = np.array(parsed_predictions["pred_corners_3d_upright_camera"])
    pred_mask = np.asarray(parsed_predictions["pred_mask"])
    obj_prob = np.asarray(parsed_predictions["obj_prob"])
    proposal_ids = np.asarray(proposal_ids)
    valid = np.asarray(valid)
    point_clouds = np.asarray(point_clouds)
    B, G, _ = proposal_ids.shape

    index_list, obj_list, pc_list, box_params_list = [], [], [], []
    for i in range(B):
        height = np.percentile(point_clouds[i, :, 2], 5)
        scene = point_clouds[i, point_clouds[i, :, 2] >= height, :3]
        for g in range(G):
            if not valid[i, g]:
                continue
            j = int(proposal_ids[i, g, 0])
            if not (pred_mask[i, j] and obj_prob[i, j] > dump_threshold):
                continue
            mesh = meshes[i * G + g]
            if len(mesh.vertices) == 0:
                continue
            pts = np.asarray(mesh.vertices)
            pts = pts - (pts.max(0) + pts.min(0)) / 2.0
            pts = pts @ TRANSFORM_SHAPENET.T
            extent = pts.max(0) - pts.min(0)
            pts = pts / np.where(extent > 0, extent, 1.0)
            if len(pts) > max_obj_points:
                pts = pts[:max_obj_points]

            box_params = _box_params_from_corners(corners_all[i, j])
            pc_in_box = _points_in_obb(
                scene, box_params[:3], 1.2 * box_params[3:6], box_params[6])
            if len(pc_in_box) < 5:
                continue
            if len(pc_in_box) > max_pc_in_box:
                pc_in_box = pc_in_box[:max_pc_in_box]

            index_list.append((i, j))
            obj_list.append((pts * box_params[3:6]).astype(np.float32))
            pc_list.append(pc_in_box.astype(np.float32))
            box_params_list.append(box_params)

    if not index_list:
        return parsed_predictions

    # pow2 buckets of the scene's maxima; every real row keeps at least one
    # zero pad point (+1 below), the reference's zero padding, which the
    # placement moves onto the box centroid: a candidate of the search
    K = len(index_list)
    n_obj = max(len(o) for o in obj_list)
    n_pc = max(len(p) for p in pc_list)
    if stats is not None:
        stats.update(proposals=K, mesh_points=n_obj, scene_points=n_pc)
    Kb = _pow2(K, 4, 1 << 30)
    No = _pow2(n_obj + 1, 512, max_obj_points)
    Np = _pow2(n_pc + 1, 1024, max_pc_in_box)

    obj = np.zeros((Kb, No, 3), np.float32)
    pc = np.zeros((Kb, Np, 3), np.float32)
    pcm = np.zeros((Kb, Np), np.float32)
    for k in range(K):
        obj[k, :len(obj_list[k])] = obj_list[k]
        pc[k, :len(pc_list[k])] = pc_list[k]
        pcm[k, :len(pc_list[k])] = 1.0

    box_params_arr = np.stack(box_params_list)
    init = np.zeros((Kb, 7), np.float32)
    init[:K] = box_params_arr
    dev = torch.device(device)
    centroids, orientations = _optimize(
        *(torch.from_numpy(a).to(dev) for a in (
            obj, pc, pcm, np.ascontiguousarray(init[:, :3]),
            np.ascontiguousarray(init[:, 6]))),
        torch.tensor(np.float32(K * max_pc_in_box), device=dev),
        iterations=iterations, rows=K, queries=n_pc,
        candidates=min(n_obj + 1, No))
    centroids = centroids.cpu().numpy()
    orientations = orientations.cpu().numpy()

    for k, (i, j) in enumerate(index_list):
        corners_all[i, j] = get_3d_box(
            box_params_arr[k, 3:6], -orientations[k],
            flip_axis_to_camera(centroids[k]))
    parsed_predictions["pred_corners_3d_upright_camera"] = corners_all
    return parsed_predictions
