"""AP accumulation and the prediction / GT assembly (host-side numpy).

The port's own copy of `rfdnet_tpu/eval/ap_helper.py`: `APCalculator`
accumulates per-scan (class, corners[, mesh], score) tuples and computes
per-class AP/AR and mAP, and with a `mesh_iou_func` the same of the mesh
IoU (`<class> Average Precision_mesh`, `mAP_mesh`, `AR_mesh`);
`assembly_pred_map_cls` expands NMS survivors into per-class proposals
(score = sem_prob * obj_prob); `parse_groundtruths` decodes the GT box
labels to camera-frame corners. The box decode and NMS of the predictions
run on the device (`ISCNet.parse_predictions`).
"""

from __future__ import annotations

import numpy as np

from ..config import MEAN_SIZE_ARR, NUM_CLASS, NUM_HEADING_BIN
from .box_util import flip_axis_to_camera
from .eval_det import eval_det


def corners_from_params(box_size, heading_angle, center_cam):
    """Vectorized get_3d_box over leading dims: sizes (..., 3) [l, w, h],
    angles (...,), centers (..., 3) -> corners (..., 8, 3)."""
    l, w, h = box_size[..., 0], box_size[..., 1], box_size[..., 2]
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64)
    sy = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float64)
    sz = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64)
    x = 0.5 * l[..., None] * sx
    y = 0.5 * h[..., None] * sy
    z = 0.5 * w[..., None] * sz
    c = np.cos(heading_angle)[..., None]
    s = np.sin(heading_angle)[..., None]
    rx = c * x + s * z
    rz = -s * x + c * z
    corners = np.stack([rx, y, rz], axis=-1)
    return corners + center_cam[..., None, :]


def parse_groundtruths(gt_data):
    """GT labels (numpy batch) -> {sem_cls_label, gt_corners_3d_upright_
    camera (B, MAX_NUM_OBJ, 8, 3), box_label_mask}."""
    center = np.asarray(gt_data["center_label"])[:, :, 0:3]
    hc = np.asarray(gt_data["heading_class_label"]).astype(np.int64)
    hr = np.asarray(gt_data["heading_residual_label"])
    sc = np.asarray(gt_data["size_class_label"]).astype(np.int64)
    sr = np.asarray(gt_data["size_residual_label"])
    mask = np.asarray(gt_data["box_label_mask"])
    sem = np.asarray(gt_data["sem_cls_label"])

    angle = hc * (2 * np.pi / NUM_HEADING_BIN) + hr
    angle = angle - 2 * np.pi * (angle > np.pi)
    sizes = MEAN_SIZE_ARR[sc] + sr
    corners = corners_from_params(sizes, -angle, flip_axis_to_camera(center))
    corners = corners * mask[..., None, None]  # zero out the padding
    return {"sem_cls_label": sem, "gt_corners_3d_upright_camera": corners,
            "box_label_mask": mask}


def assembly_pred_map_cls(parsed, conf_thresh=0.05, per_class_proposal=True,
                          meshes=None, proposal_ids=None):
    """Per scan, the (class, corners, score) of each confident NMS
    survivor: one tuple per class scored sem_prob * obj_prob
    (`per_class_proposal`), else its predicted class scored obj_prob. With
    `meshes` ((B, G) nested lists, one entry per slot) and `proposal_ids`
    ((B, G, >=1), the proposal of each slot), each tuple is (class,
    corners, score, mesh): the mesh of the slot that holds the proposal,
    None when no slot does."""
    corners = np.asarray(parsed["pred_corners_3d_upright_camera"])
    sem_probs = np.asarray(parsed["sem_cls_probs"])
    obj_prob = np.asarray(parsed["obj_prob"])
    pred_mask = np.asarray(parsed["pred_mask"])
    pred_sem_cls = np.asarray(parsed["pred_sem_cls"])

    def item(i, cls, j, score):
        if meshes is None:
            return (cls, corners[i, j], score)
        hits = np.flatnonzero(np.asarray(proposal_ids)[i, :, 0] == j)
        return (cls, corners[i, j], score,
                meshes[i][hits[0]] if len(hits) else None)

    batch = []
    for i in range(obj_prob.shape[0]):
        keep = np.where((pred_mask[i] == 1) & (obj_prob[i] > conf_thresh))[0]
        if per_class_proposal:
            cur = [item(i, ii, j, sem_probs[i, j, ii] * obj_prob[i, j])
                   for ii in range(NUM_CLASS) for j in keep]
        else:
            cur = [item(i, int(pred_sem_cls[i, j]), j, obj_prob[i, j])
                   for j in keep]
        batch.append(cur)
    return batch


def assembly_gt_map_cls(parsed_gts, meshes=None):
    """Per scan, the (class, corners) of each GT box, and with `meshes`
    ((B, MAX_NUM_OBJ) nested lists) (class, corners, mesh)."""
    sem = parsed_gts["sem_cls_label"]
    corners = parsed_gts["gt_corners_3d_upright_camera"]
    mask = parsed_gts["box_label_mask"]
    return [[(int(sem[i, j]), corners[i, j]) if meshes is None
             else (int(sem[i, j]), corners[i, j], meshes[i][j])
             for j in np.where(mask[i] == 1)[0]]
            for i in range(sem.shape[0])]


class APCalculator:
    def __init__(self, ap_iou_thresh=0.25, class2type_map=None,
                 mesh_iou_func=None, use_07_metric=True):
        """use_07_metric: 11-point interpolated AP, the reference
        evaluator's default. mesh_iou_func: with one (e.g.
        `mesh_iou.mesh_iou`), the tuples carry meshes and the mesh AP is
        computed too."""
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.mesh_iou_func = mesh_iou_func
        self.use_07_metric = use_07_metric
        self.reset()

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        if len(batch_pred_map_cls) != len(batch_gt_map_cls):
            raise ValueError("predictions and GT of different batch sizes")
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.pred_map_cls[self.scan_cnt] = pred
            self.gt_map_cls[self.scan_cnt] = gt
            self.scan_cnt += 1

    def compute_metrics(self, parallel=True):
        res = eval_det(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh,
            use_07_metric=self.use_07_metric,
            mesh_iou_func=self.mesh_iou_func, parallel=parallel)
        if self.mesh_iou_func is None:
            return self._summarize(res[0], res[2], "")
        (rec, _, ap), (rec_m, _, ap_m) = res
        return {**self._summarize(rec, ap, ""),
                **self._summarize(rec_m, ap_m, "_mesh")}

    def _summarize(self, rec, ap, suffix):
        ret = {}
        rec_list = []
        for key in sorted(ap.keys()):
            clsname = (self.class2type_map[key] if self.class2type_map
                       else str(key))
            ret[f"{clsname} Average Precision{suffix}"] = ap[key]
            try:
                r = rec[key][-1]
            except (TypeError, IndexError):
                r = 0
            ret[f"{clsname} Recall{suffix}"] = r
            rec_list.append(r)
        ret[f"mAP{suffix}"] = float(np.mean(list(ap.values()))) if ap else 0.0
        ret[f"AR{suffix}"] = float(np.mean(rec_list)) if rec_list else 0.0
        return ret
