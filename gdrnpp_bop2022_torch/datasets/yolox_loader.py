"""Detector input on the host: the letterbox and per-image detection records.

The port's copy of the serving half of
``gdrnpp_bop2022_tpu/datasets/yolox_loader.py`` (``DetRecord`` :20,
``det_records_from_instances`` :32, ``letterbox`` :82; numpy and cv2, the
same in behaviour). The mosaic / mixup training loader is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .bop_data import InstanceRecord


class DetRecord:
    """Per-image detection record: path + boxes (N, 4 xyxy) + labels (N,)."""

    __slots__ = ("rgb_path", "boxes", "labels")

    def __init__(self, rgb_path, boxes, labels):
        self.rgb_path = rgb_path
        self.boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        self.labels = np.asarray(labels, np.int64).reshape(-1)


def det_records_from_instances(records: Sequence[InstanceRecord],
                               use_visib_bbox: bool = True) -> List[DetRecord]:
    """Group flat instance records into per-image detection records."""
    by_img = {}
    for r in records:
        box = r.bbox_visib if use_visib_bbox else r.bbox_obj
        if box is None:
            continue
        by_img.setdefault(r.rgb_path, []).append((box, r.label))
    return [DetRecord(path, [b for b, _ in items], [lab for _, lab in items])
            for path, items in by_img.items()]


def letterbox(img: np.ndarray, size: int, fill: int = 114):
    """Ratio-preserving resize onto a (size, size) gray canvas, top-left
    anchored (reference ValTransform, data_augment.py:161). Returns (canvas
    uint8, ratio): boxes map as xyxy * ratio."""
    import cv2
    H, W = img.shape[:2]
    r = min(size / H, size / W)
    canvas = np.full((size, size, 3), fill, np.uint8)
    rs = cv2.resize(img, (int(W * r), int(H * r)))
    canvas[:rs.shape[0], :rs.shape[1]] = rs
    return canvas, r
