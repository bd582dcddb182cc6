"""Losses of training: the detection loss with every term and constant,
and the ONet loss.

Counterpart of `rfdnet_tpu/models/losses.py` (`_cross_entropy`,
`compute_vote_loss`, `compute_objectness_loss`,
`compute_box_and_sem_cls_loss`, `detection_loss`, `onet_loss`): NEAR 0.3
/ FAR 0.6 objectness thresholds, objectness class weights [0.2, 0.8], box
term weights 0.1 (heading class) and 0.1 (size class), total = (vote +
0.5 objectness + box + 0.1 semantic class) x 10, ONet total =
w (completion + 100 mask). GT boxes are padded to MAX_NUM_OBJ with zeros,
and the padded centers take part in the objectness assignment, as in the
JAX package and the reference. `pointseg_loss` is in `pointseg.py`.
"""

from __future__ import annotations

import math

import torch

from ..ops.nn_distance import huber_loss, nn_distance

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def _cross_entropy(logits, labels, weights=None):
    """Per-element cross entropy (torch's `reduction='none'`), logits
    (..., C), integer labels (...,) -> (...,), scaled by weights[label]
    when `weights` (C,) is given."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if weights is not None:
        w = torch.as_tensor(weights, dtype=loss.dtype, device=loss.device)
        loss = loss * w[labels.long()]
    return loss


def _take(values, index):
    """values (B, M, ...) gathered along axis 1 at index (B, K)."""
    index = index.long()
    shape = index.shape + values.shape[2:]
    return torch.gather(values, 1, index.reshape(
        *index.shape, *(1,) * (values.dim() - 2)).expand(shape))


def compute_vote_loss(est, gt):
    """Mean over the seeds on an object of the L1 distance from the seed's
    vote to the nearest of its three GT votes."""
    B, num_seed, _ = est["seed_xyz"].shape
    vote_xyz = est["vote_xyz"]
    seed_inds = est["seed_inds"]
    seed_gt_votes_mask = _take(gt["vote_label_mask"], seed_inds)
    seed_gt_votes = _take(gt["vote_label"], seed_inds)
    seed_gt_votes = seed_gt_votes + est["seed_xyz"].repeat(1, 1, 3)
    vf = vote_xyz.shape[1] // num_seed
    vote_r = vote_xyz.reshape(B * num_seed, vf, 3)
    gt_r = seed_gt_votes.reshape(B * num_seed, GT_VOTE_FACTOR, 3)
    _, _, dist2, _ = nn_distance(vote_r, gt_r, l1=True)
    votes_dist = dist2.amin(dim=1).reshape(B, num_seed)
    mask = seed_gt_votes_mask.float()
    return torch.sum(votes_dist * mask) / (torch.sum(mask) + 1e-6)


def compute_objectness_loss(est, gt):
    """Weighted CE of objectness against the label "nearest GT center
    within NEAR", over the proposals nearer than NEAR or farther than FAR.
    Returns (loss, objectness_label, objectness_mask, object_assignment)."""
    gt_center = gt["center_label"][:, :, 0:3]
    dist1, ind1, _, _ = nn_distance(est["aggregated_vote_xyz"], gt_center)
    euclidean_dist1 = torch.sqrt(dist1 + 1e-6)
    objectness_label = (euclidean_dist1 < NEAR_THRESHOLD).long()
    objectness_mask = ((euclidean_dist1 < NEAR_THRESHOLD)
                       | (euclidean_dist1 > FAR_THRESHOLD)).float()
    loss = _cross_entropy(est["objectness_scores"], objectness_label,
                          OBJECTNESS_CLS_WEIGHTS)
    loss = torch.sum(loss * objectness_mask) / (
        torch.sum(objectness_mask) + 1e-6)
    return loss, objectness_label, objectness_mask, ind1


def compute_box_and_sem_cls_loss(est, gt, object_assignment,
                                 objectness_label, mean_size_arr,
                                 num_heading_bin, num_size_cluster):
    """(center, heading class, heading residual, size class, size
    residual, semantic class) losses of the positive proposals against
    their assigned GT boxes; the center loss is the two-way chamfer of
    proposal and GT centers."""
    oa = object_assignment
    obj_w = objectness_label.float()
    denom = torch.sum(obj_w) + 1e-6

    dist1, _, dist2, _ = nn_distance(est["center"],
                                     gt["center_label"][:, :, 0:3])
    box_mask = gt["box_label_mask"].float()
    center_loss = (torch.sum(dist1 * obj_w) / denom
                   + torch.sum(dist2 * box_mask) / (
                       torch.sum(box_mask) + 1e-6))

    heading_class_label = _take(gt["heading_class_label"], oa)
    heading_class_loss = torch.sum(_cross_entropy(
        est["heading_scores"], heading_class_label) * obj_w) / denom
    heading_residual_label = _take(gt["heading_residual_label"], oa)
    hr_norm_label = heading_residual_label / (math.pi / num_heading_bin)
    h_onehot = torch.nn.functional.one_hot(
        heading_class_label.long(), num_heading_bin).float()
    hr_pred = torch.sum(est["heading_residuals_normalized"] * h_onehot,
                        dim=-1)
    heading_reg_loss = torch.sum(huber_loss(hr_pred - hr_norm_label, 1.0)
                                 * obj_w) / denom

    size_class_label = _take(gt["size_class_label"], oa)
    size_class_loss = torch.sum(_cross_entropy(
        est["size_scores"], size_class_label) * obj_w) / denom
    size_residual_label = _take(gt["size_residual_label"], oa)
    s_onehot = torch.nn.functional.one_hot(
        size_class_label.long(), num_size_cluster).float()
    sr_pred = torch.sum(est["size_residuals_normalized"]
                        * s_onehot[..., None], dim=2)
    mean_sizes = torch.as_tensor(mean_size_arr, dtype=torch.float32,
                                 device=sr_pred.device)
    mean_size_label = torch.einsum("bks,sc->bkc", s_onehot, mean_sizes)
    sr_norm_label = size_residual_label / mean_size_label
    size_reg_loss = torch.sum(huber_loss(sr_pred - sr_norm_label, 1.0)
                              .mean(dim=-1) * obj_w) / denom

    sem_cls_label = _take(gt["sem_cls_label"], oa)
    sem_cls_loss = torch.sum(_cross_entropy(
        est["sem_cls_scores"], sem_cls_label) * obj_w) / denom
    return (center_loss, heading_class_loss, heading_reg_loss,
            size_class_loss, size_reg_loss, sem_cls_loss)


def _objectness_summary(est, objectness_label, objectness_mask):
    """(pos_ratio, neg_ratio, obj_acc) over the proposals."""
    total_num_proposal = objectness_label.shape[0] * objectness_label.shape[1]
    pos_ratio = torch.sum(objectness_label.float()) / total_num_proposal
    neg_ratio = torch.sum(objectness_mask) / total_num_proposal - pos_ratio
    obj_pred = est["objectness_scores"].argmax(dim=2)
    obj_acc = torch.sum((obj_pred == objectness_label).float()
                        * objectness_mask) / (
        torch.sum(objectness_mask) + 1e-6)
    return pos_ratio, neg_ratio, obj_acc


def detection_loss(est, gt, mean_size_arr, num_heading_bin: int = 12,
                   num_size_cluster: int = 8) -> dict:
    """The detection loss's terms as scalars, `total` the one to
    differentiate."""
    vote_loss = compute_vote_loss(est, gt)
    objectness_loss, objectness_label, objectness_mask, object_assignment = (
        compute_objectness_loss(est, gt))
    pos_ratio, neg_ratio, obj_acc = _objectness_summary(
        est, objectness_label, objectness_mask)
    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss) = compute_box_and_sem_cls_loss(
        est, gt, object_assignment, objectness_label, mean_size_arr,
        num_heading_bin, num_size_cluster)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    loss = (vote_loss + 0.5 * objectness_loss + box_loss
            + 0.1 * sem_cls_loss) * 10.0
    return {
        "total": loss,
        "vote_loss": vote_loss,
        "objectness_loss": objectness_loss,
        "box_loss": box_loss,
        "sem_cls_loss": sem_cls_loss,
        "pos_ratio": pos_ratio,
        "neg_ratio": neg_ratio,
        "center_loss": center_loss,
        "heading_cls_loss": heading_cls_loss,
        "heading_reg_loss": heading_reg_loss,
        "size_cls_loss": size_cls_loss,
        "size_reg_loss": size_reg_loss,
        "obj_acc": obj_acc,
    }


def onet_loss(completion_loss, mask_loss, weight: float = 1.0) -> dict:
    """weight x (completion + 100 x mask)."""
    return {
        "total_loss": weight * (completion_loss + 100.0 * mask_loss),
        "completion_loss": completion_loss,
        "mask_loss": mask_loss,
    }
