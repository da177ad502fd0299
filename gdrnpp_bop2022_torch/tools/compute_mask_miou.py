"""Mask quality: IoU and F1 between predicted and ground-truth masks.

The port's copy of ``tools/compute_mask_miou.py`` (reference
core/gdrn_modeling/tools/compute_mIoU_mask.py), over the port's
``utils/mask_rle.py``: two directories of same-named binary mask PNGs (or
COCO-RLE json files); prints per-file and mean IoU / F1.

    python -m gdrnpp_bop2022_torch.tools.compute_mask_miou --pred preds/ --gt gts/
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def load_mask_any(path: str) -> np.ndarray:
    """A bool mask from a PNG (> 127) or a COCO-RLE json file."""
    if path.endswith(".json"):
        from ..utils import mask_rle
        with open(path) as f:
            return mask_rle.decode(json.load(f)).astype(bool)
    import cv2
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE) > 127


def iou_f1(a: np.ndarray, b: np.ndarray):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    iou = inter / max(union, 1)
    prec = inter / max(a.sum(), 1)
    rec = inter / max(b.sum(), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return float(iou), float(f1)


def mask_miou(pred_dir: str, gt_dir: str) -> dict:
    """{file: (iou, f1)} over the predictions that have a ground truth."""
    out = {}
    for p in sorted(glob.glob(os.path.join(pred_dir, "*"))):
        g = os.path.join(gt_dir, os.path.basename(p))
        if os.path.exists(g):
            out[os.path.basename(p)] = iou_f1(load_mask_any(p), load_mask_any(g))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pred", required=True)
    ap.add_argument("--gt", required=True)
    args = ap.parse_args(argv)
    res = mask_miou(args.pred, args.gt)
    for name, (iou, f1) in res.items():
        print(f"{name}: IoU {iou:.4f}  F1 {f1:.4f}")
    if res:
        ious, f1s = zip(*res.values())
        print(f"mean IoU {np.mean(ious):.4f}  mean F1 {np.mean(f1s):.4f} ({len(res)} masks)")
    return res


if __name__ == "__main__":
    main()
