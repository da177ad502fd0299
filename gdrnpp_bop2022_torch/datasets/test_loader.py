"""Test-time loader: detections -> padded fixed-size batches.

Port of ``gdrnpp_bop2022_tpu/datasets/test_loader.py`` (numpy, verbatim in
behaviour). Each batch ships a small stack of unique full images plus
per-ROI parameters; the device does the crops. Every array is padded to a
fixed size: the ROI axis to `batch_size` (`valid` masks the padding) and
the image stack to `images_per_batch` (zero frames; no ROI indexes them),
so every batch has the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from .bop_data import load_image


@dataclass
class RoiMeta:
    scene_id: int
    im_id: int
    obj_id: int
    score: float
    det_time: float


def iter_test_batches(
    images_index: Dict[str, dict],     # scene_im_id -> {rgb_path, K, ...}
    detections: Dict[str, list],       # scene_im_id -> [det dicts]
    batch_size: int = 64,
    images_per_batch: int = 16,
    with_depth: bool = False,
    depth_factor: float = 1000.0,
) -> Iterator[dict]:
    """Yields host batches:
      images (images_per_batch, H, W, 3) uint8 — padded with zero frames,
      img_idx (B,), boxes_xyxy (B, 4), Ks (B, 3, 3), labels (B,),
      scores (B,), valid (B,) bool,
      metas: list[RoiMeta] length B (padding rows repeat the last real ROI);
      with_depth also yields depths (images_per_batch, H, W) in meters
      (zeros when a depth file is missing).

    Both the ROI axis and the image axis have the same size in every
    batch, so every device pass sees the same shapes.
    """
    assert images_per_batch >= 1
    keys = [k for k in images_index if k in detections]
    keys.sort(key=lambda k: (images_index[k]["scene_id"], images_index[k]["im_id"]))

    pend_rois: List[dict] = []
    pend_metas: List[RoiMeta] = []
    pend_imgs: List[np.ndarray] = []
    pend_depths: List[np.ndarray] = []
    pend_img_ids: Dict[str, int] = {}

    def flush():
        nonlocal pend_rois, pend_metas, pend_imgs, pend_depths, pend_img_ids
        if not pend_rois:
            return None
        B = batch_size
        n = len(pend_rois)
        rois = pend_rois + [pend_rois[-1]] * (B - n)
        metas = pend_metas + [pend_metas[-1]] * (B - n)
        # pad the image stack to the static size with zero frames
        h, w, c = pend_imgs[0].shape
        n_img = len(pend_imgs)
        imgs = np.zeros((images_per_batch, h, w, c), pend_imgs[0].dtype)
        imgs[:n_img] = np.stack(pend_imgs)
        batch = {
            "images": imgs,
            "img_idx": np.array([r["img_idx"] for r in rois], np.int32),
            "boxes_xyxy": np.stack([r["bbox_xyxy"] for r in rois]).astype(np.float32),
            "Ks": np.stack([r["K"] for r in rois]).astype(np.float32),
            "labels": np.array([r["label"] for r in rois], np.int32),
            "scores": np.array([r["score"] for r in rois], np.float32),
            "valid": np.array([i < n for i in range(B)], bool),
            "metas": metas,
        }
        if with_depth:
            deps = np.zeros((images_per_batch, h, w), np.float32)
            deps[:n_img] = np.stack(pend_depths)
            batch["depths"] = deps
        pend_rois, pend_metas, pend_imgs, pend_depths, pend_img_ids = \
            [], [], [], [], {}
        return batch

    def load_entry(entry):
        img = load_image(entry["rgb_path"])
        dep = None
        if with_depth:
            from .bop_data import load_depth
            dp = entry.get("depth_path")
            if dp:
                dep = load_depth(dp, entry.get("depth_scale", 1.0),
                                 depth_factor)
            else:
                dep = np.zeros(img.shape[:2], np.float32)
        return img, dep

    for key in keys:
        entry = images_index[key]
        dets = detections[key]
        # flush first if this image's ROIs don't fit the ROI budget, or if
        # it needs a fresh image slot and the stack is full
        if pend_rois and (len(pend_rois) + len(dets) > batch_size
                          or (key not in pend_img_ids
                              and len(pend_imgs) >= images_per_batch)):
            out = flush()
            if out is not None:
                yield out
        if key not in pend_img_ids:
            pend_img_ids[key] = len(pend_imgs)
            img, dep = load_entry(entry)
            pend_imgs.append(img)
            if with_depth:
                pend_depths.append(dep)
        gi = pend_img_ids[key]
        for det in dets:
            if len(pend_rois) >= batch_size:
                # single image with more ROIs than batch: flush mid-image
                img = pend_imgs[gi]
                dep = pend_depths[gi] if with_depth else None
                out = flush()
                if out is not None:
                    yield out
                pend_img_ids[key] = 0
                pend_imgs.append(img)
                if with_depth:
                    pend_depths.append(dep)
                gi = 0
            pend_rois.append({
                "img_idx": gi,
                "bbox_xyxy": det["bbox_xyxy"],
                "K": entry["K"],
                "label": det["label"],
                "score": det["score"],
            })
            pend_metas.append(RoiMeta(
                scene_id=entry["scene_id"], im_id=entry["im_id"],
                obj_id=det["obj_id"], score=det["score"],
                det_time=det.get("time", 0.0)))
    out = flush()
    if out is not None:
        yield out
