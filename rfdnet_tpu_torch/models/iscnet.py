"""ISCNet: detection + instance completion.

Counterpart of `rfdnet_tpu/models/iscnet.py`: the training forward
(`forward`: detection, `select_completion_proposals`, `_complete` with the
ONet loss over the selected proposals) and `loss`, in train or eval mode
(torch's module mode; submodules named in `frozen` stay in eval mode), and
the test-time generation path (`detect`, `parse_predictions`,
`generate_detections`, `generate_completion` with and without GT fields,
`generate` with the eval completion loss, the 16^3 shape voxels and
`decode_grid_res`, `decode_occupancy`). Every occupancy decode of eval
mode goes through the fused CBN decoder (`ONet.decode_fused`, the CUDA
kernel on the card); train mode decodes layer by layer, with batch
statistics and autograd. Variable-size results (NMS survivors, completed
proposals) stay fixed-shape with validity masks, as in the JAX package.

`data_group` (None, or a `collectives.DataGroup` that
`common.set_data_group` sets on the model, its skip propagation, its
completion network and its batch norms): the batch this process holds
is one rank's rows of a global batch, and the losses (the completion and
mask losses of `forward` and `generate`, and `loss`) are the global
batch's parts (`collectives.global_sum`).
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
from ..utils.profiling import count, span
from .backbone import Pointnet2Backbone
from .common import set_compute_dtype
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
                 cluster_sampling: str = "seed_fps",
                 input_feature_dim: int = 1, completion_feature_dim: int = 1,
                 phase: str = "completion", skip_propagate: bool = True,
                 c_dim: int = 512, hidden_dim: int = 512, z_dim: int = 32,
                 use_cls_for_completion: bool = False,
                 generate_limit: int = 64, decoder_bf16: bool = False,
                 threshold: float = 0.5, completion_limit: int = 10,
                 frozen: tuple = (), mlp_dtype=None):
        """`completion_limit`: proposals completed per scene in the
        training forward (`data.completion_limit_in_train`). `frozen`:
        submodules held in eval mode when the model trains (the reference
        freezes a module's parameters and switches it to eval; the update
        mask is the trainer's). `mlp_dtype`: torch.bfloat16 runs the shared
        MLPs of the backbone, the voting, the vote aggregation and the skip
        propagation as bf16 chains (`data.mlp_bf16`, see
        `common.set_compute_dtype`); None keeps f32."""
        super().__init__()
        self.num_class = num_class
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        self.completion_limit = completion_limit
        self.frozen = tuple(frozen)
        self.data_group = None
        self.phase = phase
        self.skip_propagate = skip_propagate
        self.generate_limit = generate_limit
        # dataset constant, not a weight: kept out of the state_dict
        self.register_buffer("mean_size_arr", torch.as_tensor(
            np.asarray(mean_size_arr), dtype=torch.float32), persistent=False)
        self.backbone = Pointnet2Backbone(input_feature_dim)
        self.voting = VotingModule(vote_factor=vote_factor)
        self.detection = ProposalModule(
            num_class=num_class, num_heading_bin=num_heading_bin,
            num_size_cluster=num_size_cluster, num_proposal=num_proposal,
            sampling=cluster_sampling,
        )
        if phase == "completion":
            if skip_propagate:
                self.skip_propagation = SkipPropagation(
                    c_dim=c_dim, hidden_dim=hidden_dim,
                    input_feature_dim=completion_feature_dim,
                )
            self.completion = ONet(
                z_dim=z_dim,
                c_dim=c_dim if skip_propagate else 128,
                use_cls_for_completion=use_cls_for_completion,
                num_class=num_class, decoder_bf16=decoder_bf16,
                threshold=threshold,
            )
        if mlp_dtype is not None:
            for m in (self.backbone, self.voting,
                      self.detection.vote_aggregation,
                      getattr(self, "skip_propagation", None)):
                if m is not None:
                    set_compute_dtype(m, mlp_dtype)

    def train(self, mode: bool = True):
        super().train(mode)
        for name in self.frozen:
            if hasattr(self, name):
                getattr(self, name).eval()
        return self

    def detect(self, point_clouds, generator=None):
        """backbone -> voting -> proposal (spans `iscnet.backbone`,
        `iscnet.voting_proposal`). Returns (end_points, proposal_features
        (B, K, 128)). `generator`: see `ProposalModule.forward`."""
        with span("iscnet.backbone"):
            end_points = self.backbone(point_clouds)
        with span("iscnet.voting_proposal"):
            return self._vote_and_propose(end_points, generator)

    def _vote_and_propose(self, end_points, generator):
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
        return self.detection(xyz, features, end_points, generator=generator)

    def _heading_angles(self, end_points):
        pred_heading_class = end_points["heading_scores"].argmax(dim=-1)
        hr = end_points["heading_residuals_normalized"] * (
            math.pi / self.num_heading_bin)
        residual = torch.gather(hr, -1, pred_heading_class[..., None])[..., 0]
        return class2angle(pred_heading_class, residual, self.num_heading_bin)

    def _complete(self, end_points, proposal_features, proposal_ids, data,
                  eps=None, generator=None):
        """Gather the selected proposals (B, P, 3) [proposal, GT box,
        class], skip-propagate them with the instance labels of `data`,
        and compute the ONet loss on their GT boxes' occupancy sets.
        Returns (features (B, P, c_dim), completion loss, mask loss,
        16^3 voxels or None (with `data["export_shape"]`)). `eps` /
        `generator`: the posterior noise of train mode, see
        `ONet.compute_loss`."""
        B, P, _ = proposal_ids.shape
        pids = proposal_ids[..., 0].long()
        gt_ids = proposal_ids[..., 1].long()
        with span("iscnet.skip_propagation"):
            sel_features = gather_points(proposal_features, pids)
            pred_centers = gather_points(end_points["center"], pids)
            heading_angles = torch.gather(self._heading_angles(end_points),
                                          1, pids)
            if self.skip_propagate:
                object_input_features, mask_loss = self.skip_propagation(
                    pred_centers, heading_angles, sel_features,
                    data["point_clouds"], data.get("point_instance_labels"),
                    torch.gather(data["object_instance_labels"], 1, gt_ids))
            else:
                object_input_features = sel_features
                mask_loss = torch.zeros((), device=pids.device)
        T = data["object_points"].shape[2]
        input_points = torch.gather(
            data["object_points"], 1,
            gt_ids[..., None, None].expand(B, P, T, 3))
        input_occ = torch.gather(data["object_points_occ"], 1,
                                 gt_ids[..., None].expand(B, P, T))
        cls_codes = torch.nn.functional.one_hot(
            proposal_ids[..., 2].long(), self.num_class).float()
        completion_loss, shape_example = self.completion.compute_loss(
            object_input_features.reshape(B * P, -1),
            input_points.reshape(B * P, T, 3), input_occ.reshape(B * P, T),
            cls_codes.reshape(B * P, -1),
            export_shape=bool(data.get("export_shape", False)), eps=eps,
            generator=generator)
        return object_input_features, completion_loss, mask_loss, shape_example

    def forward(self, data: dict, eps=None, generator=None):
        """The training forward, in train or eval mode: detection, then in
        the completion phase the `completion_limit` proposals of
        `select_completion_proposals` (or `data["pinned_proposal_ids"]`)
        completed against their GT objects.

        data: point_clouds and the GT fields of `ScanNetDataset`. eps
        (B * completion_limit, z_dim): the posterior noise of train mode,
        else drawn from `generator` (which also feeds `random`
        sampling). Returns (end_points, losses (2,) [completion, mask],
        16^3 voxels or None, proposal_ids (B, P, 3) or None)."""
        end_points, proposal_features = self.detect(data["point_clouds"],
                                                    generator=generator)
        if self.phase != "completion":
            zero = torch.zeros((), device=data["point_clouds"].device)
            return end_points, torch.stack([zero, zero]), None, None
        if "pinned_proposal_ids" in data:
            proposal_ids = data["pinned_proposal_ids"]
        else:
            proposal_ids = select_completion_proposals(
                torch.softmax(end_points["objectness_scores"], dim=-1)[..., 1],
                end_points["center"], data["center_label"][:, :, 0:3],
                data["box_label_mask"], data["sem_cls_label"],
                self.completion_limit)
        _, completion_loss, mask_loss, shape_example = self._complete(
            end_points, proposal_features, proposal_ids, data, eps=eps,
            generator=generator)
        return (end_points, torch.stack([completion_loss, mask_loss]),
                shape_example, proposal_ids)

    def loss(self, out, data: dict, completion_weight: float = 1.0) -> dict:
        """The loss terms of `forward`'s output `out` against `data`:
        `detection_loss`, and in the completion phase the ONet loss
        weighted by `completion_weight` added to `total`."""
        end_points, completion_losses = out[:2]
        total = detection_loss(end_points, data, self.mean_size_arr,
                               self.num_heading_bin, self.num_size_cluster,
                               group=self.data_group)
        if self.phase == "completion":
            cl = onet_loss(completion_losses[0], completion_losses[1],
                           completion_weight)
            total["completion_loss"] = cl["completion_loss"]
            total["mask_loss"] = cl["mask_loss"]
            total["total"] = total["total"] + cl["total_loss"]
        return total

    def generate_detections(self, point_clouds, nms_iou=0.25,
                            use_cls_nms=True, remove_empty_box=False):
        """Eval detection + box decode + NMS (span `iscnet.nms`: the host
        NMS loop and its copies) -> (end_points, proposal_features,
        parsed)."""
        end_points, proposal_features = self.detect(point_clouds)
        with span("iscnet.nms"):
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
                            data, dump_threshold=0.5):
        """The top-`generate_limit` NMS survivors above `dump_threshold`,
        skip-propagated into conditioning codes. With GT fields in `data`
        (`center_label`, `box_label_mask`, `sem_cls_label`), each proposal
        is assigned the nearest GT center (the first on a tie) and takes
        its class; with instance labels too (`point_instance_labels`,
        `object_instance_labels`) skip propagation is the supervised one
        and reports its mask loss over the valid slots.

        Returns proposal_ids (B, G, 3) [proposal, gt, class], valid
        (B, G), features (B*G, c_dim), cls_codes (B*G, num_class), centers,
        heading_angles, mask_loss. All of it is the span
        `iscnet.skip_propagation`."""
        with span("iscnet.skip_propagation"):
            return self._generate_completion(
                end_points, proposal_features, parsed, data, dump_threshold)

    def _generate_completion(self, end_points, proposal_features, parsed,
                             data, dump_threshold):
        B, K = parsed["obj_prob"].shape
        G = min(self.generate_limit, K)
        eligible = parsed["pred_mask"] & (parsed["obj_prob"] > dump_threshold)
        score = torch.where(eligible, parsed["obj_prob"], -1.0)
        # lax.top_k keeps the lower index first among ties: a stable sort
        top_scores, top_ids = torch.sort(score, dim=1, descending=True,
                                         stable=True)
        top_scores, top_ids = top_scores[:, :G], top_ids[:, :G]
        valid = top_scores > 0.0
        if "center_label" in data:
            d = torch.sum((end_points["center"][:, :, None, :]
                           - data["center_label"][:, None, :, 0:3]) ** 2,
                          dim=-1)
            d = torch.where(data["box_label_mask"][:, None, :] > 0, d,
                            torch.inf)
            # argmin takes the first index of the minimum, all-masked -> 0
            assign = torch.argmin(d, dim=-1)
            gt_ids = torch.gather(assign, 1, top_ids)
            cls_ids = torch.gather(data["sem_cls_label"].long(), 1, gt_ids)
        else:
            gt_ids = torch.zeros_like(top_ids)
            cls_ids = torch.gather(parsed["pred_sem_cls"], 1, top_ids)
        proposal_ids = torch.stack([top_ids, gt_ids, cls_ids], dim=-1).to(
            torch.int32)

        sel_features = gather_points(proposal_features, top_ids)
        pred_centers = gather_points(end_points["center"], top_ids)
        heading_angles = torch.gather(self._heading_angles(end_points), 1,
                                      top_ids)
        point_clouds = data["point_clouds"]
        mask_loss = torch.zeros((), device=score.device)
        if not self.skip_propagate:
            object_input_features = sel_features
        elif "point_instance_labels" in data:
            proposal_instance_labels = torch.gather(
                data["object_instance_labels"], 1, gt_ids)
            object_input_features, mask_loss = self.skip_propagation(
                pred_centers, heading_angles, sel_features, point_clouds,
                data["point_instance_labels"], proposal_instance_labels,
                slot_mask=valid)
        else:
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
            "centers": pred_centers,
            "heading_angles": heading_angles,
            "mask_loss": mask_loss,
        }

    @torch.no_grad()
    def generate(self, data: dict, nms_iou=0.25, use_cls_nms=True,
                 dump_threshold=0.5, remove_empty_box=False,
                 export_voxels=True, decode_grid_res=None, grid_padding=0.1,
                 grid_sample: bool = False, grid_mxu_dtype=None):
        """Test-time forward: detection + NMS and, in the completion phase,
        completion conditioning. With `object_points` and
        `object_points_occ` in `data` (the GT objects' occupancy sets), also
        the eval completion loss of each slot's assigned object
        (`completion_loss`) and, with `export_voxels`, the 16^3 shape
        voxels as packed bits (`shape_voxels_bits`, (B*G, 512) uint8 in
        `np.packbits` order). With `decode_grid_res`, every selected
        proposal's dense occupancy logit grid (`grids`, (B*G, nx, nx,
        nx)), at the prior-mean z or, with `grid_sample`, at `sample_z`'s
        draw, in `grid_mxu_dtype` operands (the decoder's own when None;
        the Tester's `generation.decoder_impl`). Eval mode only.

        Spans: `iscnet.generate` over the call; `iscnet.backbone`,
        `iscnet.voting_proposal`, `iscnet.nms`, `iscnet.skip_propagation`,
        `iscnet.completion_loss` (with `object_points`) and
        `iscnet.grid_decode` (with `decode_grid_res`), which counts the
        grids decoded (`iscnet.slots_decoded`, B * G) and the valid ones
        among them (`iscnet.slots_valid`, on the device)."""
        if self.training:
            raise RuntimeError("ISCNet.generate runs in eval mode")
        with span("iscnet.generate"):
            return self._generate(
                data, nms_iou, use_cls_nms, dump_threshold, remove_empty_box,
                export_voxels, decode_grid_res, grid_padding, grid_sample,
                grid_mxu_dtype)

    def _generate(self, data, nms_iou, use_cls_nms, dump_threshold,
                  remove_empty_box, export_voxels, decode_grid_res,
                  grid_padding, grid_sample, grid_mxu_dtype):
        pc = data["point_clouds"]
        end_points, proposal_features, parsed = self.generate_detections(
            pc, nms_iou=nms_iou, use_cls_nms=use_cls_nms,
            remove_empty_box=remove_empty_box,
        )
        out = {"end_points": end_points, "parsed": parsed}
        if self.phase != "completion":
            return out
        gen = self.generate_completion(
            end_points, proposal_features, parsed, data,
            dump_threshold=dump_threshold,
        )
        out["gen"] = gen
        if "object_points" in data:
            with span("iscnet.completion_loss"):
                self._completion_loss(data, gen, export_voxels, out)
        if decode_grid_res:
            with span("iscnet.grid_decode"):
                nx = int(decode_grid_res)
                pts = (1.0 + grid_padding) * make_3d_grid(
                    (-0.5,) * 3, (0.5,) * 3, (nx,) * 3, device=pc.device)
                Nb = gen["features"].shape[0]
                logits = self.decode_occupancy(
                    gen["features"], gen["cls_codes"],
                    pts[None].expand(Nb, -1, -1), sample=grid_sample,
                    mxu_dtype=grid_mxu_dtype)
                out["grids"] = logits.reshape(Nb, nx, nx, nx)
                count("iscnet.slots_decoded", Nb)
                count("iscnet.slots_valid", gen["valid"])
        return out

    def _completion_loss(self, data, gen, export_voxels, out) -> None:
        """The eval completion loss of each slot's assigned GT object and,
        with `export_voxels`, the 16^3 shape voxels, into `out`."""
        B, G, _ = gen["proposal_ids"].shape
        gt_ids = gen["proposal_ids"][..., 1].long()
        T = data["object_points"].shape[2]
        input_points = torch.gather(
            data["object_points"], 1,
            gt_ids[..., None, None].expand(B, G, T, 3)).reshape(B * G, T, 3)
        input_occ = torch.gather(
            data["object_points_occ"], 1,
            gt_ids[..., None].expand(B, G, T)).reshape(B * G, T)
        loss, voxels = self.completion.compute_loss(
            gen["features"], input_points, input_occ, gen["cls_codes"],
            export_shape=export_voxels, valid_mask=gen["valid"].reshape(-1))
        out["completion_loss"] = loss
        if voxels is not None:
            out["shape_voxels_bits"] = pack_bits(voxels.reshape(B * G, -1))

    @torch.no_grad()
    def decode_occupancy(self, features, cls_codes, points, z=None,
                         sample: bool = False, mxu_dtype=None):
        """features (Nb, c_dim), cls_codes (Nb, num_class), points
        (Nb, T, 3) -> logits (Nb, T), through the fused CBN decoder in
        `mxu_dtype` operands (the decoder's own when None). z: (Nb, z_dim)
        given, else with `sample` `sample_z`'s draw (the
        `generation.use_sampling` option), else the prior mean."""
        return self.occupancy_decoder(features, cls_codes, z, sample,
                                      mxu_dtype)(points)

    @torch.no_grad()
    def occupancy_decoder(self, features, cls_codes, z=None,
                          sample: bool = False, mxu_dtype=None):
        """`decode_occupancy` bound to one scene's proposals: the CBN tables
        are folded once and z is drawn once, then the result decodes
        points (k, T, 3) of proposals `rows` ((k,) int64, all when None)
        -> logits (k, T), as often as needed (the MISE levels)."""
        c = self.completion._cond(features, cls_codes)
        if z is None:
            z = (self.sample_z(c.shape[0], c.device) if sample
                 else torch.zeros((c.shape[0], self.completion.z_dim),
                                  device=c.device))
        bound = self.completion.bind_fused(z, c, mxu_dtype)

        def decode(points, rows=None):
            with torch.no_grad():
                return bound(points, rows)

        return decode

    def gradient_decoder(self, features, cls_codes, z=None,
                         sample: bool = False):
        """`occupancy_decoder`'s counterpart that autograd can differentiate
        with respect to the points (refine and normals): the same z, the
        layer-by-layer chain `ONet.decode` in eval mode in place of the
        fused kernel, which has no backward. Call it under grad mode."""
        if self.training:
            raise RuntimeError("gradient_decoder decodes in eval mode")
        c = self.completion._cond(features, cls_codes).detach()
        if z is None:
            z = (self.sample_z(c.shape[0], c.device) if sample
                 else torch.zeros((c.shape[0], self.completion.z_dim),
                                  device=c.device))

        def decode(points, rows=None):
            if rows is None:
                return self.completion.decode(points, z, c)
            return self.completion.decode(points, z[rows], c[rows])

        return decode

    def sample_z(self, nb: int, device=None, seed: int = 42) -> torch.Tensor:
        """One prior draw of z for each of nb proposals, (nb, z_dim), from a
        CPU generator seeded `seed`: the same values on every device."""
        g = torch.Generator().manual_seed(seed)
        return torch.randn((nb, self.completion.z_dim), generator=g).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Booleans (..., 8k) -> uint8 (..., k), big-endian within each byte:
    the layout of `np.packbits(bits, axis=-1)`."""
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=bits.device)
    grouped = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.uint8)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)
