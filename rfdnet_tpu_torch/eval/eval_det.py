"""VOC-style detection AP (host-side numpy).

The port's own copy of `rfdnet_tpu/eval/eval_det.py` (box AP only; the
joint mesh AP waits for `eval/mesh_iou.py`): per-class greedy TP/FP
matching at an IoU threshold, the precision envelope, VOC AP (11-point
optional). The classes are scored in a pool of processes started with
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
                 get_iou_func=get_iou_obb):
    """Single-class precision/recall. pred: {img_id: [(bbox, score)]};
    gt: {img_id: [bbox]}. Returns (rec, prec, ap)."""
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array(gt[img_id])
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
    for img_id in pred.keys():
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, BB = [], [], []
    for img_id in pred.keys():
        for item in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(item[1])
            BB.append(item[0])
    confidence = np.array(confidence)
    BB = np.array(BB)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if BB.size else BB
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d, ...].astype(float)
        ovmax, jmax = -np.inf, -1
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            for j in range(BBGT.shape[0]):
                iou = get_iou_func(bb, BBGT[j, ...])
                if iou > ovmax:
                    ovmax, jmax = iou, j
        if ovmax > ovthresh:
            if not R["det"][jmax]:
                tp[d] = 1.0
                R["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _eval_cls_worker(args):
    pred, gt, ovthresh, use_07 = args
    return eval_det_cls(pred, gt, ovthresh, use_07)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             parallel=True):
    """Multi-class AP. pred_all: {img_id: [(classname, bbox, score)]};
    gt_all: {img_id: [(classname, bbox)]}. Returns (rec, prec, ap) dicts
    keyed by class."""
    pred, gt = {}, {}
    for img_id in pred_all.keys():
        for item in pred_all[img_id]:
            pred.setdefault(item[0], {}).setdefault(img_id, []).append(
                item[1:])
    for img_id in gt_all.keys():
        for item in gt_all[img_id]:
            gt.setdefault(item[0], {}).setdefault(img_id, []).append(item[1])

    classes = list(gt.keys())
    jobs = [(pred.get(c, {}), gt[c], ovthresh, use_07_metric)
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

    rec, prec, ap = {}, {}, {}
    for c, res in zip(classes, results):
        rec[c], prec[c], ap[c] = res
    for c in pred.keys():
        if c not in gt:
            rec[c], prec[c], ap[c] = 0.0, 0.0, 0.0
    return rec, prec, ap
