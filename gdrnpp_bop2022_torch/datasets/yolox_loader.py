"""Detector input on the host: the letterbox, per-image detection records and
the mosaic / mixup training loader.

The port's copy of ``gdrnpp_bop2022_tpu/datasets/yolox_loader.py``
(``DetRecord`` :20, ``det_records_from_instances`` :32, ``_random_affine``
:47, ``letterbox`` :82, ``YoloxTrainLoader`` :99; reference
det/yolox/data/datasets/mosaicdetection.py and data_augment.py), numpy and
cv2 on the host with the same ``np.random.RandomState`` draws in the same
order, so that a seed gives the JAX loader's batches bit for bit: mosaic of
four letterboxed images on a 2S canvas and a random affine onto S x S,
mixup with a scale-jittered fifth image, HSV jitter, horizontal flip, and
the boxes padded to ``max_gt`` rows in cxcywh. One worker thread builds
batches ahead into a queue of two.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import List, Sequence

import numpy as np

from .bop_data import InstanceRecord, load_image


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


def _random_affine(img, boxes, labels, rng, degrees=10.0, translate=0.1,
                   scales=(0.5, 1.5), shear=2.0, out_wh=None):
    """Rotation, scale and shear about the image centre, then a translation
    to around the output's centre (reference random_affine,
    data_augment.py:133); boxes are the warped corners' bounds, clipped, and
    those no wider or taller than 2 pixels are dropped."""
    import cv2
    H, W = img.shape[:2]
    tw, th = out_wh or (W, H)
    a = np.deg2rad(rng.uniform(-degrees, degrees))
    s = rng.uniform(*scales)
    shx = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    shy = np.tan(np.deg2rad(rng.uniform(-shear, shear)))
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * tw
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * th
    ca, sa = np.cos(a) * s, np.sin(a) * s
    A = np.array([[ca, -sa], [sa, ca]], np.float32) @ \
        np.array([[1.0, shx], [shy, 1.0]], np.float32)
    c0 = A @ np.array([W / 2.0, H / 2.0], np.float32)
    M = np.array([[A[0, 0], A[0, 1], tx - c0[0]],
                  [A[1, 0], A[1, 1], ty - c0[1]]], np.float32)
    img2 = cv2.warpAffine(img, M, (tw, th), borderValue=(114, 114, 114))
    if len(boxes):
        corners = np.concatenate([
            boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [0, 3]], boxes[:, [2, 3]]], axis=0)
        ones = np.ones((len(corners), 1), np.float32)
        warped = (np.concatenate([corners, ones], 1) @ M.T).reshape(4, -1, 2)
        new = np.concatenate([warped.min(0), warped.max(0)], 1)
        new[:, 0::2] = new[:, 0::2].clip(0, tw)
        new[:, 1::2] = new[:, 1::2].clip(0, th)
        keep = ((new[:, 2] - new[:, 0]) > 2) & ((new[:, 3] - new[:, 1]) > 2)
        boxes, labels = new[keep], labels[keep]
    return img2, boxes, labels


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


class YoloxTrainLoader:
    """Infinite mosaic / mixup loader of padded detection batches: dicts of
    images (B, S, S, 3) uint8, gt_boxes (B, max_gt, 4) cxcywh float32,
    gt_labels (B, max_gt) int32 and gt_valid (B, max_gt) bool. The trainer
    turns mosaic and mixup off for its last iterations through
    ``mosaic_prob``, ``mixup_prob`` and ``enable_aug``."""

    def __init__(self, records: Sequence[DetRecord], batch_size: int,
                 input_size: int = 640, max_gt: int = 60,
                 mosaic_prob: float = 1.0, mixup_prob: float = 0.5,
                 hsv_prob: float = 1.0, flip_prob: float = 0.5,
                 degrees: float = 10.0, translate: float = 0.1,
                 mosaic_scale=(0.1, 2.0), mixup_scale=(0.5, 1.5),
                 shear: float = 2.0,
                 enable_aug: bool = True, seed: int = 0):
        """The geometry knobs are the reference MosaicDetection recipe's
        (configs/yolox/bop_pbr/yolox_base.py:149-160)."""
        if not records:
            raise ValueError("YoloxTrainLoader needs at least one record")
        self.records = list(records)
        self.bs = batch_size
        self.size = input_size
        self.max_gt = max_gt
        self.mosaic_prob = mosaic_prob if enable_aug else 0.0
        self.mixup_prob = mixup_prob if enable_aug else 0.0
        self.hsv_prob = hsv_prob if enable_aug else 0.0
        self.flip_prob = flip_prob if enable_aug else 0.0
        self.degrees = degrees
        self.translate = translate
        self.mosaic_scale = tuple(mosaic_scale)
        self.mixup_scale = tuple(mixup_scale)
        self.shear = shear
        self.enable_aug = enable_aug
        self.rng = np.random.RandomState(seed)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _load(self, rec: DetRecord):
        """The record's image resized by the letterbox ratio (no canvas),
        its boxes scaled alike."""
        import cv2
        img = load_image(rec.rgb_path)
        H, W = img.shape[:2]
        r = min(self.size / H, self.size / W)
        img = cv2.resize(img, (int(W * r), int(H * r)))
        return img, rec.boxes * r, rec.labels.copy()

    def _mosaic(self):
        s = self.size
        yc = int(self.rng.uniform(0.5 * s, 1.5 * s))
        xc = int(self.rng.uniform(0.5 * s, 1.5 * s))
        canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
        all_boxes, all_labels = [], []
        for i in range(4):
            rec = self.records[self.rng.randint(len(self.records))]
            img, boxes, labels = self._load(rec)
            h, w = img.shape[:2]
            if i == 0:
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
                x1b, y1b = 0, h - (y2a - y1a)
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(yc + h, 2 * s)
                x1b, y1b = w - (x2a - x1a), 0
            else:
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(yc + h, 2 * s)
                x1b, y1b = 0, 0
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
            if len(boxes):
                b = boxes.copy()
                b[:, 0::2] += x1a - x1b
                b[:, 1::2] += y1a - y1b
                all_boxes.append(b)
                all_labels.append(labels)
        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
        labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int64)
        return _random_affine(canvas, boxes, labels, self.rng, degrees=self.degrees,
                              translate=self.translate, scales=self.mosaic_scale,
                              shear=self.shear, out_wh=(s, s))

    def _mixup(self, img, boxes, labels):
        import cv2
        rec = self.records[self.rng.randint(len(self.records))]
        img2, boxes2, labels2 = self._load(rec)
        jit = self.rng.uniform(*self.mixup_scale)
        if abs(jit - 1.0) > 1e-6:
            h2, w2 = img2.shape[:2]
            img2 = cv2.resize(img2, (max(int(w2 * jit), 1), max(int(h2 * jit), 1)))
            boxes2 = boxes2 * jit
        canvas = np.full((self.size, self.size, 3), 114, np.uint8)
        h, w = img2.shape[:2]
        canvas[:min(h, self.size), :min(w, self.size)] = \
            img2[:min(h, self.size), :min(w, self.size)]
        out = (img.astype(np.float32) * 0.5 + canvas.astype(np.float32) * 0.5).astype(np.uint8)
        keep = (boxes2[:, 2].clip(max=self.size) - boxes2[:, 0].clip(0) > 2) \
            & (boxes2[:, 3].clip(max=self.size) - boxes2[:, 1].clip(0) > 2)
        boxes = np.concatenate([boxes, boxes2[keep].clip(0, self.size)])
        labels = np.concatenate([labels, labels2[keep]])
        return out, boxes, labels

    def _hsv(self, img):
        import cv2
        gains = self.rng.uniform(-1, 1, 3) * [0.015, 0.7, 0.4] + 1
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] * gains[0]) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] * gains[1], 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * gains[2], 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)

    def _one(self):
        if self.rng.uniform() < self.mosaic_prob:
            img, boxes, labels = self._mosaic()
            if self.rng.uniform() < self.mixup_prob:
                img, boxes, labels = self._mixup(img, boxes, labels)
        else:
            rec = self.records[self.rng.randint(len(self.records))]
            img, boxes, labels = self._load(rec)
            canvas = np.full((self.size, self.size, 3), 114, np.uint8)
            h, w = img.shape[:2]
            canvas[:h, :w] = img
            img = canvas
        if self.rng.uniform() < self.hsv_prob:
            img = self._hsv(img)
        if self.rng.uniform() < self.flip_prob:
            img = img[:, ::-1]
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = self.size - boxes[:, [2, 0]]
        G = self.max_gt
        out_boxes = np.zeros((G, 4), np.float32)
        out_labels = np.zeros((G,), np.int32)
        valid = np.zeros((G,), bool)
        n = min(len(boxes), G)
        if n:
            b = boxes[:n]
            out_boxes[:n, 0] = (b[:, 0] + b[:, 2]) / 2
            out_boxes[:n, 1] = (b[:, 1] + b[:, 3]) / 2
            out_boxes[:n, 2] = b[:, 2] - b[:, 0]
            out_boxes[:n, 3] = b[:, 3] - b[:, 1]
            out_labels[:n] = labels[:n]
            valid[:n] = True
        return np.ascontiguousarray(img), out_boxes, out_labels, valid

    def _build_batch(self):
        imgs, bxs, lbs, vds = zip(*[self._one() for _ in range(self.bs)])
        return {"images": np.stack(imgs), "gt_boxes": np.stack(bxs),
                "gt_labels": np.stack(lbs), "gt_valid": np.stack(vds)}

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._build_batch()
            except Exception as e:      # handed to the consumer, raised by __next__
                self._queue.put(e)
                return
            self._queue.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker: it ends after the batch it is building (the
        queue is drained so that its put does not block)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                pass
        self._thread.join()
