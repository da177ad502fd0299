"""Detection evaluation and the stage-1 -> stage-2 handoff json.

Port of ``gdrnpp_bop2022_tpu/eval/detection_eval.py``:
``detections_to_bop_json`` (:19) writes the test_bboxes json that GDRN's
test loader reads (``datasets.det_files_test``; reference
yolox_coco_evaluator.py convert_to_coco_format_bop :211);
``evaluate_yolox_records`` (:52) runs the port's detector over per-image
records; ``coco_map`` (:124) is the in-process COCO-style AP (101-point
interpolated, IoU 0.5:0.95), numpy as in the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence

import numpy as np
import torch


def detections_to_bop_json(
    per_image: Dict[str, dict],
    label_to_obj_id: Dict[int, int],
    scale_factors: Dict[str, float] | None = None,
) -> Dict[str, list]:
    """NMS outputs -> {"scene/im": [{obj_id, bbox_est xywh, score, time}]}.

    per_image: scene_im_id -> {boxes_xyxy (D,4), scores (D,), labels (D,),
    valid (D,), time: float} (numpy); scale_factors maps boxes back to the
    original image resolution (the inverse of the letterbox resize).
    """
    out = {}
    for key, det in per_image.items():
        s = 1.0 / (scale_factors or {}).get(key, 1.0)
        rows = []
        boxes = np.asarray(det["boxes_xyxy"])
        scores = np.asarray(det["scores"])
        labels = np.asarray(det["labels"])
        valid = np.asarray(det["valid"]).astype(bool)
        for i in np.nonzero(valid & (scores > 0))[0]:
            x1, y1, x2, y2 = boxes[i] * s
            rows.append({
                "obj_id": int(label_to_obj_id[int(labels[i])]),
                "bbox_est": [float(x1), float(y1),
                             float(x2 - x1), float(y2 - y1)],
                "score": float(scores[i]),
                "time": float(det.get("time", 0.0)),
            })
        if rows:
            out[key] = rows
    return out


def evaluate_yolox_records(model, det_records, input_size: int, num_classes: int,
                           conf_thr: float = 0.3, nms_thr: float = 0.65,
                           max_dets: int = 32, batch_size: int = 8) -> Dict[str, float]:
    """Run the detector over per-image DetRecords (the same letterbox as
    deployment, the last batch padded with its last image) and score mAP
    against their own GT boxes. Returns coco_map's dict (mAP, AP50)."""
    from ..datasets.bop_data import load_image
    from ..datasets.yolox_loader import letterbox
    from ..models.yolox.yolox import make_inference

    infer = make_inference(model, conf_thr=conf_thr, nms_thr=nms_thr, max_dets=max_dets)
    device = next(model.parameters()).device
    dets, gts = {}, {}
    recs = list(det_records)
    for i0 in range(0, len(recs), batch_size):
        chunk = recs[i0:i0 + batch_size]
        imgs, ratios = [], []
        for r in chunk:
            canvas, ratio = letterbox(load_image(r.rgb_path), input_size)
            imgs.append(canvas)
            ratios.append(ratio)
        imgs += [imgs[-1]] * (batch_size - len(chunk))
        x = torch.from_numpy(np.stack(imgs)).to(device).float()
        out = {k: v.cpu().numpy() for k, v in infer(x).items()}
        for j, r in enumerate(chunk):
            keep = out["valid"][j] & (out["scores"][j] > conf_thr)
            boxes = out["boxes_xyxy"][j][keep] / ratios[j]
            dets[r.rgb_path] = [
                {"bbox_xyxy": b.tolist(), "score": float(s), "label": int(lab)}
                for b, s, lab in zip(boxes, out["scores"][j][keep], out["labels"][j][keep])]
            gts[r.rgb_path] = [{"bbox_xyxy": b.tolist(), "label": int(lab)}
                               for b, lab in zip(r.boxes, r.labels)]
    return coco_map(dets, gts, num_classes)


def _voc_ap(recall, precision):
    """101-point interpolated AP (COCO-style)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    pts = np.linspace(0, 1, 101)
    return float(np.mean(np.interp(pts, mrec, mpre)))


def coco_map(
    dets: Dict[str, list],        # image -> [{"bbox_xyxy", "score", "label"}]
    gts: Dict[str, list],         # image -> [{"bbox_xyxy", "label"}]
    num_classes: int,
    iou_thrs: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """In-process COCO-style mAP."""
    def iou(a, b):
        tl = np.maximum(a[:, None, :2], b[None, :, :2])
        br = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.clip(br - tl, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        ar_a = np.prod(a[:, 2:] - a[:, :2], -1)
        ar_b = np.prod(b[:, 2:] - b[:, :2], -1)
        return inter / np.maximum(ar_a[:, None] + ar_b[None] - inter, 1e-9)

    aps = []
    ap50s = []
    for cls in range(num_classes):
        cls_dets = []   # (img_key, score, box)
        n_gt = 0
        gt_by_img = {}
        for key in set(list(dets.keys()) + list(gts.keys())):
            g = [x for x in gts.get(key, []) if x["label"] == cls]
            gt_by_img[key] = np.array([x["bbox_xyxy"] for x in g],
                                      np.float32).reshape(-1, 4)
            n_gt += len(g)
            for d in dets.get(key, []):
                if d["label"] == cls:
                    cls_dets.append((key, d["score"], d["bbox_xyxy"]))
        if n_gt == 0:
            continue
        cls_dets.sort(key=lambda x: -x[1])
        for ti, thr in enumerate(iou_thrs):
            matched = defaultdict(set)
            tp = np.zeros(len(cls_dets))
            fp = np.zeros(len(cls_dets))
            for i, (key, score, box) in enumerate(cls_dets):
                g = gt_by_img[key]
                if len(g) == 0:
                    fp[i] = 1
                    continue
                ious = iou(np.asarray(box, np.float32).reshape(1, 4), g)[0]
                order = np.argsort(-ious)
                hit = False
                for j in order:
                    if ious[j] < thr:
                        break
                    if j not in matched[key]:
                        matched[key].add(j)
                        hit = True
                        break
                tp[i] = hit
                fp[i] = not hit
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            rec = ctp / n_gt
            prec = ctp / np.maximum(ctp + cfp, 1e-9)
            ap = _voc_ap(rec, prec)
            aps.append(ap)
            if ti == 0:
                ap50s.append(ap)
    return {"mAP": float(np.mean(aps)) if aps else 0.0,
            "AP50": float(np.mean(ap50s)) if ap50s else 0.0}
