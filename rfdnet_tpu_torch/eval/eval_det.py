"""VOC-style detection AP (host-side numpy).

The port's own copy of `rfdnet_tpu/eval/eval_det.py`: per-class greedy
TP/FP matching at an IoU threshold, the precision envelope, VOC AP
(11-point optional), and with a `mesh_iou_func` the mesh AP scored in the
same pass as the box AP. The classes are scored in a pool of processes started with
`spawn` (a fork after CUDA has started, with the Tester's worker thread
alive, is unsafe), with a serial fallback. A spawned worker imports this
package afresh, so its modules do no work at import beyond importing.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .box_util import get_iou_obb


def voc_ap(rec, prec, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) != 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False,
                 get_iou_func=get_iou_obb, mesh_iou_func=None):
    """Single-class precision/recall. pred: {img_id: [(bbox, score)]} (or
    [(bbox, score, mesh)] with `mesh_iou_func`); gt: {img_id: [bbox]} (or
    [(bbox, mesh)]). Returns (rec, prec, ap), and with `mesh_iou_func` a
    second such triple of the mesh IoU, scored in the same pass."""
    with_mesh = mesh_iou_func is not None
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        items = gt[img_id]
        if with_mesh:
            bbox = np.array([it[0] for it in items])
            mesh = [it[1] for it in items]
        else:
            bbox, mesh = np.array(items), []
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox),
                              "mesh": mesh, "det_mesh": [False] * len(bbox)}
    for img_id in pred.keys():
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": [],
                                  "mesh": [], "det_mesh": []}

    image_ids, confidence, BB, meshes = [], [], [], []
    for img_id in pred.keys():
        for item in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(item[1])
            BB.append(item[0])
            if with_mesh:
                meshes.append(item[2])
    confidence = np.array(confidence)
    BB = np.array(BB)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if BB.size else BB
    image_ids = [image_ids[x] for x in sorted_ind]
    if with_mesh:
        meshes = [meshes[x] for x in sorted_ind]

    nd = len(image_ids)
    tp, fp = np.zeros(nd), np.zeros(nd)
    tp_mesh, fp_mesh = np.zeros(nd), np.zeros(nd)

    def match(d, ov, j, det, tp, fp):
        if ov > ovthresh and not det[j]:
            tp[d] = 1.0
            det[j] = True
        else:
            fp[d] = 1.0

    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d, ...].astype(float)
        ovmax, jmax = -np.inf, -1
        ovmax_mesh, jmax_mesh = -np.inf, -1
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            for j in range(BBGT.shape[0]):
                iou = get_iou_func(bb, BBGT[j, ...])
                if iou > ovmax:
                    ovmax, jmax = iou, j
                if with_mesh:
                    iou_m = mesh_iou_func(meshes[d], R["mesh"][j])
                    if iou_m > ovmax_mesh:
                        ovmax_mesh, jmax_mesh = iou_m, j
        match(d, ovmax, jmax, R["det"], tp, fp)
        if with_mesh:
            match(d, ovmax_mesh, jmax_mesh, R["det_mesh"], tp_mesh, fp_mesh)

    def pr(tp, fp):
        fp = np.cumsum(fp)
        tp = np.cumsum(tp)
        rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        return rec, prec, voc_ap(rec, prec, use_07_metric)

    if with_mesh:
        return pr(tp, fp), pr(tp_mesh, fp_mesh)
    return pr(tp, fp)


def _eval_cls_worker(args):
    pred, gt, ovthresh, use_07, mesh_iou_func = args
    return eval_det_cls(pred, gt, ovthresh, use_07,
                        mesh_iou_func=mesh_iou_func)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             mesh_iou_func=None, parallel=True):
    """Multi-class AP. pred_all: {img_id: [(classname, bbox, score[,
    mesh])]}; gt_all: {img_id: [(classname, bbox[, mesh])]}. Returns
    (rec, prec, ap) dicts keyed by class, and with `mesh_iou_func` (a
    module-level function, which the spawned workers unpickle) a second
    such triple of the mesh AP."""
    with_mesh = mesh_iou_func is not None
    pred, gt = {}, {}
    for img_id in pred_all.keys():
        for item in pred_all[img_id]:
            pred.setdefault(item[0], {}).setdefault(img_id, []).append(
                item[1:])
    for img_id in gt_all.keys():
        for item in gt_all[img_id]:
            entry = tuple(item[1:]) if with_mesh else item[1]
            gt.setdefault(item[0], {}).setdefault(img_id, []).append(entry)

    classes = list(gt.keys())
    jobs = [(pred.get(c, {}), gt[c], ovthresh, use_07_metric, mesh_iou_func)
            for c in classes]
    results = None
    if parallel and len(classes) > 1 and (os.cpu_count() or 1) > 1:
        try:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=min(10, len(classes)),
                                     mp_context=ctx) as ex:
                results = list(ex.map(_eval_cls_worker, jobs))
        except (OSError, RuntimeError):  # no processes here: serially
            results = None
    if results is None:
        results = [_eval_cls_worker(j) for j in jobs]

    box, mesh = ({}, {}, {}), ({}, {}, {})
    for c, res in zip(classes, results):
        for out, triple in zip((box, mesh), res if with_mesh else (res,)):
            for d, v in zip(out, triple):
                d[c] = v
    for c in pred.keys():
        if c not in gt:
            for out in (box, mesh) if with_mesh else (box,):
                for d in out:
                    d[c] = 0.0
    return (box, mesh) if with_mesh else box
