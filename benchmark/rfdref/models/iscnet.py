"""ISCNet: detection + instance completion, in the completion phase with
skip propagation and seed_fps proposals (the two configurations the
benchmark runs).

Counterpart of `rfdnet_tpu/models/iscnet.py`: the training forward
(`forward`: detection, `select_completion_proposals`, `_complete` with the
ONet loss over the selected proposals) and `loss`, in train mode (torch's
module mode), and the test-time path without GT fields (`detect`,
`parse_predictions`, `generate_detections`, `generate_completion`,
`generate` to the dense grids, `decode_occupancy` at the prior-mean z).
Eval mode decodes the grids through the fused CBN decoder's plain chain
(`ONet.bind_fused`); train mode decodes layer by layer, with batch
statistics and autograd. Variable-size results (NMS survivors, completed
proposals) stay fixed-shape with validity masks, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import (
    class2angle,
    class2size,
    corners_to_aabb,
    flip_axis_to_camera,
    gather_points,
    get_3d_box_batch,
    nms_3d,
)
from .backbone import Pointnet2Backbone
from .losses import detection_loss, onet_loss
from .occnet import ONet, make_3d_grid
from .proposal import ProposalModule
from .skip_propagation import SkipPropagation
from .voting import VotingModule


def select_completion_proposals(objectness_probs, center, gt_center,
                                box_label_mask, sem_cls_label, limit: int):
    """The proposals to complete in training: ranked by objectness
    (descending, the lower index first on a tie), the first proposal of
    each assigned GT box first, in GT id order, then the rest in
    objectness order, cut to `limit`. A proposal's GT box is the nearest
    valid GT center (the first on a tie).

    objectness_probs (B, K), center (B, K, 3), gt_center (B, M, 3),
    box_label_mask (B, M), sem_cls_label (B, M) -> (B, limit, 3) int32
    [proposal id, GT box id, class id]."""
    B, K = objectness_probs.shape
    M = gt_center.shape[1]
    dev = objectness_probs.device
    d = torch.sum((center[:, :, None, :] - gt_center[:, None, :, :]) ** 2,
                  dim=-1)
    d = torch.where(box_label_mask[:, None, :] > 0, d, torch.inf)
    assign = torch.argmin(d, dim=-1)
    order = torch.argsort(-objectness_probs, dim=1, stable=True)
    sorted_gt = torch.gather(assign, 1, order)
    pos = torch.arange(K, device=dev).expand(B, K)
    # the first position of each GT box in objectness order
    minidx = torch.full((B, M), K, dtype=torch.long, device=dev).scatter_reduce(
        1, sorted_gt, pos, reduce="amin")
    is_first = torch.gather(minidx, 1, sorted_gt) == pos
    key = torch.where(is_first, sorted_gt, M + pos)
    gt_ids = torch.argsort(key, dim=1, stable=True)[:, :limit]
    sample_ids = torch.gather(order, 1, gt_ids)
    gt_box_ids = torch.gather(assign, 1, sample_ids)
    cls_ids = torch.gather(sem_cls_label.long(), 1, gt_box_ids)
    return torch.stack([sample_ids, gt_box_ids, cls_ids], dim=-1).to(
        torch.int32)


class ISCNet(nn.Module):
    def __init__(self, num_class: int = 8, num_heading_bin: int = 12,
                 num_size_cluster: int = 8, mean_size_arr=None,
                 num_proposal: int = 256, vote_factor: int = 1,
                 input_feature_dim: int = 1, completion_feature_dim: int = 1,
                 c_dim: int = 512, hidden_dim: int = 512, z_dim: int = 32,
                 use_cls_for_completion: bool = False,
                 generate_limit: int = 64, completion_limit: int = 10):
        """`completion_limit`: proposals completed per scene in the
        training forward (`data.completion_limit_in_train`)."""
        super().__init__()
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.completion_limit = completion_limit
        self.generate_limit = generate_limit
        # dataset constant, not a weight: kept out of the state_dict
        self.register_buffer("mean_size_arr", torch.as_tensor(
            np.asarray(mean_size_arr), dtype=torch.float32), persistent=False)
        self.backbone = Pointnet2Backbone(input_feature_dim)
        self.voting = VotingModule(vote_factor=vote_factor)
        self.detection = ProposalModule(
            num_class=num_class, num_heading_bin=num_heading_bin,
            num_size_cluster=num_size_cluster, num_proposal=num_proposal)
        self.skip_propagation = SkipPropagation(
            c_dim=c_dim, hidden_dim=hidden_dim,
            input_feature_dim=completion_feature_dim)
        self.completion = ONet(
            z_dim=z_dim, c_dim=c_dim,
            use_cls_for_completion=use_cls_for_completion,
            num_class=num_class)

    def detect(self, point_clouds):
        """backbone -> voting -> proposal. Returns (end_points,
        proposal_features (B, K, 128))."""
        end_points = self.backbone(point_clouds)
        xyz = end_points["fp2_xyz"]
        features = end_points["fp2_features"]
        end_points["seed_inds"] = end_points["fp2_inds"]
        end_points["seed_xyz"] = xyz
        end_points["seed_features"] = features
        xyz, features = self.voting(xyz, features)
        # L2-normalise, guarded against a zero norm
        norm = torch.linalg.vector_norm(features, dim=-1, keepdim=True)
        features = features / torch.clamp(norm, min=1e-8)
        end_points["vote_xyz"] = xyz
        end_points["vote_features"] = features
        end_points, proposal_features = self.detection(
            xyz, features, end_points)
        return end_points, proposal_features

    def _heading_angles(self, end_points):
        pred_heading_class = end_points["heading_scores"].argmax(dim=-1)
        hr = end_points["heading_residuals_normalized"] * (
            math.pi / self.num_heading_bin)
        residual = torch.gather(hr, -1, pred_heading_class[..., None])[..., 0]
        return class2angle(pred_heading_class, residual, self.num_heading_bin)

    def _complete(self, end_points, proposal_features, proposal_ids, data,
                  eps):
        """Gather the selected proposals (B, P, 3) [proposal, GT box,
        class], skip-propagate them with the instance labels of `data`,
        and compute the ONet loss on their GT boxes' occupancy sets at the
        posterior noise `eps`. Returns (completion loss, mask loss)."""
        B, P, _ = proposal_ids.shape
        pids = proposal_ids[..., 0].long()
        gt_ids = proposal_ids[..., 1].long()
        sel_features = gather_points(proposal_features, pids)
        pred_centers = gather_points(end_points["center"], pids)
        heading_angles = torch.gather(self._heading_angles(end_points), 1,
                                      pids)
        object_input_features, mask_loss = self.skip_propagation(
            pred_centers, heading_angles, sel_features,
            data["point_clouds"], data["point_instance_labels"],
            torch.gather(data["object_instance_labels"], 1, gt_ids))
        T = data["object_points"].shape[2]
        input_points = torch.gather(
            data["object_points"], 1,
            gt_ids[..., None, None].expand(B, P, T, 3))
        input_occ = torch.gather(data["object_points_occ"], 1,
                                 gt_ids[..., None].expand(B, P, T))
        cls_codes = torch.nn.functional.one_hot(
            proposal_ids[..., 2].long(), self.num_class).float()
        completion_loss = self.completion.compute_loss(
            object_input_features.reshape(B * P, -1),
            input_points.reshape(B * P, T, 3), input_occ.reshape(B * P, T),
            cls_codes.reshape(B * P, -1), eps)
        return completion_loss, mask_loss

    def forward(self, data: dict, eps):
        """The training forward: detection, then the `completion_limit`
        proposals of `select_completion_proposals` completed against their
        GT objects.

        data: point_clouds and the GT fields of the loader. eps
        (B * completion_limit, z_dim): the posterior noise. Returns
        (end_points, losses (2,) [completion, mask])."""
        end_points, proposal_features = self.detect(data["point_clouds"])
        proposal_ids = select_completion_proposals(
            torch.softmax(end_points["objectness_scores"], dim=-1)[..., 1],
            end_points["center"], data["center_label"][:, :, 0:3],
            data["box_label_mask"], data["sem_cls_label"],
            self.completion_limit)
        completion_loss, mask_loss = self._complete(
            end_points, proposal_features, proposal_ids, data, eps)
        return end_points, torch.stack([completion_loss, mask_loss])

    def loss(self, out, data: dict, completion_weight: float = 1.0) -> dict:
        """The loss terms of `forward`'s output `out` against `data`:
        `detection_loss`, and the ONet loss weighted by
        `completion_weight` added to `total`."""
        end_points, completion_losses = out
        total = detection_loss(end_points, data, self.mean_size_arr,
                               self.num_heading_bin, self.num_size_cluster)
        cl = onet_loss(completion_losses[0], completion_losses[1],
                       completion_weight)
        total["completion_loss"] = cl["completion_loss"]
        total["mask_loss"] = cl["mask_loss"]
        total["total"] = total["total"] + cl["total_loss"]
        return total

    def generate_detections(self, point_clouds, nms_iou=0.25,
                            use_cls_nms=True, remove_empty_box=False):
        """Eval detection + box decode + NMS -> (end_points,
        proposal_features, parsed)."""
        end_points, proposal_features = self.detect(point_clouds)
        parsed = self.parse_predictions(
            end_points, nms_iou, use_cls_nms, point_clouds=point_clouds,
            remove_empty_box=remove_empty_box,
        )
        return end_points, proposal_features, parsed

    def _points_in_boxes(self, pc, centers, c, s, size, chunk: int = 32):
        """Count of scene points inside each oriented box (the exact,
        unenlarged half extents). pc (N, 3), centers (K, 3), c/s (K,)
        heading cos/sin, size (K, 3) -> (K,)."""
        parts = []
        for k0 in range(0, centers.shape[0], chunk):
            rel = pc[None, :, :] - centers[k0:k0 + chunk, None, :]
            cc, ss = c[k0:k0 + chunk, None], s[k0:k0 + chunk, None]
            half = size[k0:k0 + chunk, None, :] * 0.5
            lx = cc * rel[..., 0] + ss * rel[..., 1]
            ly = -ss * rel[..., 0] + cc * rel[..., 1]
            inside = ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
                      & (rel[..., 2].abs() <= half[..., 2]))
            parts.append(inside.sum(dim=-1))
        return torch.cat(parts)

    def parse_predictions(self, end_points, nms_iou=0.25, use_cls_nms=True,
                          point_clouds=None, remove_empty_box=False):
        heading_angles = self._heading_angles(end_points)
        pred_size_class = end_points["size_scores"].argmax(dim=-1)
        mean_sizes = self.mean_size_arr
        size_residuals = (end_points["size_residuals_normalized"]
                          * mean_sizes[None, None, :, :])
        B, K = pred_size_class.shape
        pred_size_residual = torch.gather(
            size_residuals, 2,
            pred_size_class[..., None, None].expand(B, K, 1, 3))[:, :, 0, :]
        box_size = class2size(pred_size_class, pred_size_residual, mean_sizes)

        center_cam = flip_axis_to_camera(end_points["center"])
        corners_cam = get_3d_box_batch(box_size, -heading_angles, center_cam)

        obj_prob = torch.softmax(end_points["objectness_scores"], dim=-1)[..., 1]
        sem_cls_probs = torch.softmax(end_points["sem_cls_scores"], dim=-1)
        pred_sem_cls = end_points["sem_cls_scores"].argmax(dim=-1)

        valid = None
        if remove_empty_box and point_clouds is not None:
            # drop proposals whose box holds fewer than 5 scene points
            c, s = torch.cos(heading_angles), torch.sin(heading_angles)
            counts = torch.stack([
                self._points_in_boxes(point_clouds[b, :, :3],
                                      end_points["center"][b], c[b], s[b],
                                      box_size[b])
                for b in range(B)
            ])
            valid = counts >= 5

        pred_mask = nms_3d(corners_to_aabb(corners_cam), obj_prob,
                           pred_sem_cls if use_cls_nms else None, nms_iou,
                           valid=valid)
        return {
            "pred_corners_3d_upright_camera": corners_cam,
            "sem_cls_probs": sem_cls_probs,
            "obj_prob": obj_prob,
            "pred_sem_cls": pred_sem_cls,
            "pred_mask": pred_mask,
            "heading_angles": heading_angles,
            "box_size": box_size,
        }

    def generate_completion(self, end_points, proposal_features, parsed,
                            point_clouds, dump_threshold=0.5):
        """The top-`generate_limit` NMS survivors above `dump_threshold`,
        skip-propagated into conditioning codes; each takes its predicted
        class (no GT fields).

        Returns proposal_ids (B, G, 3) [proposal, 0, class], valid (B, G),
        features (B*G, c_dim), cls_codes (B*G, num_class)."""
        B, K = parsed["obj_prob"].shape
        G = min(self.generate_limit, K)
        eligible = parsed["pred_mask"] & (parsed["obj_prob"] > dump_threshold)
        score = torch.where(eligible, parsed["obj_prob"], -1.0)
        # lax.top_k keeps the lower index first among ties: a stable sort
        top_scores, top_ids = torch.sort(score, dim=1, descending=True,
                                         stable=True)
        top_scores, top_ids = top_scores[:, :G], top_ids[:, :G]
        valid = top_scores > 0.0
        gt_ids = torch.zeros_like(top_ids)
        cls_ids = torch.gather(parsed["pred_sem_cls"], 1, top_ids)
        proposal_ids = torch.stack([top_ids, gt_ids, cls_ids], dim=-1).to(
            torch.int32)

        sel_features = gather_points(proposal_features, top_ids)
        pred_centers = gather_points(end_points["center"], top_ids)
        heading_angles = torch.gather(self._heading_angles(end_points), 1,
                                      top_ids)
        object_input_features = self.skip_propagation.generate(
            pred_centers, heading_angles, sel_features, point_clouds)
        sel_sem_scores = gather_points(end_points["sem_cls_scores"], top_ids)
        cls_codes = (sel_sem_scores >= sel_sem_scores.amax(
            dim=-1, keepdim=True)).float()
        return {
            "proposal_ids": proposal_ids,
            "valid": valid,
            "features": object_input_features.reshape(B * G, -1),
            "cls_codes": cls_codes.reshape(B * G, -1),
        }

    @torch.no_grad()
    def generate(self, data: dict, decode_grid_res: int, nms_iou=0.25,
                 use_cls_nms=True, dump_threshold=0.5,
                 remove_empty_box=False, grid_padding=0.1):
        """Test-time forward: detection + NMS, completion conditioning, and
        every selected proposal's dense occupancy logit grid (`grids`,
        (B*G, nx, nx, nx), nx = `decode_grid_res`) at the prior-mean z.
        Eval mode only."""
        if self.training:
            raise RuntimeError("ISCNet.generate runs in eval mode")
        pc = data["point_clouds"]
        end_points, proposal_features, parsed = self.generate_detections(
            pc, nms_iou=nms_iou, use_cls_nms=use_cls_nms,
            remove_empty_box=remove_empty_box,
        )
        gen = self.generate_completion(
            end_points, proposal_features, parsed, pc,
            dump_threshold=dump_threshold,
        )
        nx = int(decode_grid_res)
        pts = (1.0 + grid_padding) * make_3d_grid(
            (-0.5,) * 3, (0.5,) * 3, (nx,) * 3, device=pc.device)
        Nb = gen["features"].shape[0]
        logits = self.decode_occupancy(
            gen["features"], gen["cls_codes"], pts[None].expand(Nb, -1, -1))
        return {"end_points": end_points, "parsed": parsed, "gen": gen,
                "grids": logits.reshape(Nb, nx, nx, nx)}

    @torch.no_grad()
    def decode_occupancy(self, features, cls_codes, points):
        """features (Nb, c_dim), cls_codes (Nb, num_class), points
        (Nb, T, 3) -> logits (Nb, T), through the fused CBN decoder's
        chain at the prior-mean z."""
        c = self.completion._cond(features, cls_codes)
        z = torch.zeros((c.shape[0], self.completion.z_dim), device=c.device)
        return self.completion.bind_fused(z, c)(points)
