"""Host-side BOP dataset indexing for serving and training.

Port of ``gdrnpp_bop2022_tpu/datasets/bop_data.py`` (numpy/cv2 host code,
kept close to verbatim): one generic BOP reader, as every BOP split is
scene dirs with scene_gt/scene_gt_info/scene_camera.json plus rgb/ (and
mask_visib/, mask/ for training). The host indexes records and loads
images and masks; the crops happen on the device (engine/batching.py).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..bop.inout import (load_json, load_scene_camera, load_scene_gt,
                         load_scene_gt_info)
from .meta import DatasetMeta


@dataclass
class InstanceRecord:
    scene_id: int
    im_id: int
    rgb_path: str
    depth_path: Optional[str]
    K: np.ndarray              # (3, 3)
    obj_id: int
    label: int                 # contiguous 0-based
    pose: Optional[np.ndarray]  # (3, 4) [R|t] in meters, None at test
    bbox_visib: Optional[np.ndarray]   # xyxy
    bbox_obj: Optional[np.ndarray]     # xyxy (amodal)
    visib_fract: float
    mask_visib_path: Optional[str]
    mask_full_path: Optional[str]
    inst_id: int = 0
    depth_scale: float = 1.0

    @property
    def scene_im_id(self) -> str:
        return f"{self.scene_id}/{self.im_id}"


def _xywh_to_xyxy(b):
    x, y, w, h = b
    return np.array([x, y, x + w, y + h], np.float32)


def index_bop_split(
    split_dir: str,
    meta: DatasetMeta,
    visib_thr: float = 0.0,
    scenes: Optional[Sequence[int]] = None,
    with_masks: bool = True,
    rgb_ext: str = ".png",
    cache_path: Optional[str] = None,
) -> List[InstanceRecord]:
    """Index one BOP split directory into flat per-instance records.

    Layout: split_dir/<scene:06d>/{scene_gt.json, scene_gt_info.json,
    scene_camera.json, rgb/<im:06d>.png, mask_visib/<im>_<inst>.png}.
    """
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    obj2label = meta.obj_id_to_label()
    records: List[InstanceRecord] = []
    scene_names = sorted(d for d in os.listdir(split_dir)
                         if d.isdigit() and os.path.isdir(os.path.join(split_dir, d)))
    for sname in scene_names:
        sid = int(sname)
        if scenes is not None and sid not in scenes:
            continue
        sdir = os.path.join(split_dir, sname)
        gt = load_scene_gt(os.path.join(sdir, "scene_gt.json"))
        cam = load_scene_camera(os.path.join(sdir, "scene_camera.json"))
        info_path = os.path.join(sdir, "scene_gt_info.json")
        info = load_scene_gt_info(info_path) if os.path.exists(info_path) else {}
        rgb_dir = "rgb" if os.path.isdir(os.path.join(sdir, "rgb")) else "gray"
        for im_id, gts in gt.items():
            K = cam[im_id]["cam_K"].astype(np.float32)
            depth_scale = float(cam[im_id].get("depth_scale", 1.0))
            rgb_path = os.path.join(sdir, rgb_dir, f"{im_id:06d}{rgb_ext}")
            if not os.path.exists(rgb_path):
                for ext in (".jpg", ".png", ".tif"):
                    alt = os.path.join(sdir, rgb_dir, f"{im_id:06d}{ext}")
                    if os.path.exists(alt):
                        rgb_path = alt
                        break
            depth_path = os.path.join(sdir, "depth", f"{im_id:06d}.png")
            if not os.path.exists(depth_path):
                depth_path = None
            im_infos = info.get(im_id, [{}] * len(gts))
            for inst_id, g in enumerate(gts):
                obj_id = g["obj_id"]
                if obj_id not in obj2label:
                    continue
                ii = im_infos[inst_id] if inst_id < len(im_infos) else {}
                visib = float(ii.get("visib_fract", 1.0))
                if visib < visib_thr:
                    continue
                bbox_visib = (_xywh_to_xyxy(ii["bbox_visib"])
                              if "bbox_visib" in ii else None)
                bbox_obj = (_xywh_to_xyxy(ii["bbox_obj"])
                            if "bbox_obj" in ii else None)
                pose = np.concatenate(
                    [g["cam_R_m2c"], g["cam_t_m2c"] * 1e-3], axis=1
                ).astype(np.float32) if "cam_R_m2c" in g else None
                mvp = os.path.join(sdir, "mask_visib", f"{im_id:06d}_{inst_id:06d}.png")
                mfp = os.path.join(sdir, "mask", f"{im_id:06d}_{inst_id:06d}.png")
                records.append(InstanceRecord(
                    scene_id=sid, im_id=im_id, rgb_path=rgb_path,
                    depth_path=depth_path, K=K, obj_id=obj_id,
                    label=obj2label[obj_id], pose=pose,
                    bbox_visib=bbox_visib, bbox_obj=bbox_obj,
                    visib_fract=visib,
                    mask_visib_path=mvp if with_masks and os.path.exists(mvp) else None,
                    mask_full_path=mfp if with_masks and os.path.exists(mfp) else None,
                    inst_id=inst_id, depth_scale=depth_scale,
                ))
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(records, f)
    return records


def load_detections(det_file: str, meta: DatasetMeta,
                    top_k_per_obj: int = 1, score_thr: float = 0.0) -> Dict[str, list]:
    """Load stage-1 detections json (reference: dataset_utils.py:146-241).

    Format: {"<scene>/<im>": [{"obj_id", "bbox_est" xywh, "score", "time"}]}.
    Returns the same mapping with per-obj top-k + threshold applied and
    labels attached.
    """
    raw = load_json(det_file)
    obj2label = meta.obj_id_to_label()
    out: Dict[str, list] = {}
    for scene_im_id, dets in raw.items():
        per_obj: Dict[int, list] = {}
        for det in dets:
            if det.get("score", 1.0) < score_thr:
                continue
            if det["obj_id"] not in obj2label:
                continue
            per_obj.setdefault(det["obj_id"], []).append(det)
        sel = []
        for obj_id, lst in per_obj.items():
            lst = sorted(lst, key=lambda d: -d.get("score", 1.0))[:top_k_per_obj]
            for det in lst:
                sel.append({
                    "obj_id": obj_id,
                    "label": obj2label[obj_id],
                    "bbox_xyxy": _xywh_to_xyxy(det["bbox_est"]),
                    "score": float(det.get("score", 1.0)),
                    "time": float(det.get("time", 0.0)),
                })
        if sel:
            out[scene_im_id] = sel
    return out


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3)."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[2] == 3:
        img = img[:, :, ::-1]  # BGR -> RGB
    elif img.shape[2] == 4:
        img = img[:, :, [2, 1, 0]]
    return np.ascontiguousarray(img)


def load_mask(path: str) -> np.ndarray:
    """A BOP mask PNG as float32 {0, 1} (H, W)."""
    import cv2
    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        raise FileNotFoundError(path)
    return (m > 127).astype(np.float32)


def load_depth(path: str, depth_scale: float, depth_factor: float) -> np.ndarray:
    """Depth in meters: raw * depth_scale / 1000 (BOP convention)."""
    import cv2
    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(path)
    return d.astype(np.float32) * depth_scale / 1000.0


def gt_detections(records: List[InstanceRecord],
                  bbox_type: str = "AMODAL_CLIP") -> Dict[str, list]:
    """MODEL.LOAD_DETS_TEST=False (the reference default, gdrn_base.py:10 +
    data_loader.py:923): evaluate on the GT annotations' boxes instead of a
    stage-1 detector file. Returns the mapping ``load_detections`` yields,
    with score 1.0 per instance."""
    out: Dict[str, list] = {}
    for r in records:
        box = (r.bbox_visib if bbox_type == "VISIB" or r.bbox_obj is None
               else r.bbox_obj)
        if box is None:
            continue
        out.setdefault(r.scene_im_id, []).append({
            "obj_id": r.obj_id, "label": r.label,
            "bbox_xyxy": np.asarray(box, np.float32),
            "score": 1.0, "time": 0.0})
    return out


def make_records_by_image(records: List[InstanceRecord]) -> Dict[str, dict]:
    """Group per-instance records into per-image entries (test indexing)."""
    by_im: Dict[str, dict] = {}
    for r in records:
        e = by_im.setdefault(r.scene_im_id, {
            "scene_id": r.scene_id, "im_id": r.im_id, "rgb_path": r.rgb_path,
            "depth_path": r.depth_path, "K": r.K, "depth_scale": r.depth_scale,
            "instances": []})
        e["instances"].append(r)
    return by_im
