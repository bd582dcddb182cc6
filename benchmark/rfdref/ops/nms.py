"""Greedy 3D NMS over axis-aligned boxes.

Counterpart of `rfdnet_tpu/ops/nms.py` `nms_3d`, with its semantics:
descending-score order from a STABLE sort (`jnp.argsort` is stable),
suppression on a strictly greater overlap, optional class awareness, and
invalid boxes that neither keep nor suppress. The suppression matrix is
built on the device; the K-step greedy pass over it runs on the host,
where each step is a cheap vector operation instead of a device launch.
"""

from __future__ import annotations

import torch

from .boxes import aabb_pairwise_iou


def _nms_single(boxes, s, c, v, iou_threshold):
    K = boxes.shape[0]
    s = torch.where(v, s, -torch.inf)
    order = torch.sort(-s, stable=True).indices
    b_o = boxes[order]
    v_o = v[order]
    overlap = aabb_pairwise_iou(b_o)
    c_o = c[order]
    overlap = overlap * (c_o[:, None] == c_o[None, :])
    ar = torch.arange(K, device=boxes.device)
    later = ar[None, :] > ar[:, None]
    sup = ((overlap > iou_threshold) & later & v_o[None, :]).cpu().numpy()
    keep = v_o.cpu().numpy().copy()
    for i in range(K):
        if keep[i]:  # alive (keep starts as the valid mask)
            keep &= ~sup[i]
    out = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    out[order] = torch.from_numpy(keep).to(boxes.device)
    return out


def nms_3d(aabb: torch.Tensor, score: torch.Tensor, cls, iou_threshold: float,
           valid=None) -> torch.Tensor:
    """aabb (B, K, 6), score (B, K), cls (B, K) int or None (class-agnostic),
    valid (B, K) bool or None -> (B, K) bool keep mask."""
    if cls is None:
        cls = torch.zeros(score.shape, dtype=torch.int64, device=score.device)
    if valid is None:
        valid = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    return torch.stack([
        _nms_single(aabb[b], score[b], cls[b], valid[b], iou_threshold)
        for b in range(aabb.shape[0])
    ])
