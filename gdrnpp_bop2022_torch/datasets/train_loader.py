"""Training data loader: sampled instance records -> stacked host batches.

Port of ``gdrnpp_bop2022_tpu/datasets/train_loader.py`` (numpy/cv2 host
code; reference data_loader.py:318-645, :842-899) for stacked batches: the
host only loads images and masks and applies the DZI jitter; crops, online
GT rendering and targets happen on the device
(``engine/batching.py::build_train_batch_online``). Builder threads keep up
to ``prefetch`` batches ready while the device computes, decode threads load
a batch's files in parallel (cv2 releases the GIL), and an LRU of decoded
files in host RAM (``cache_gb``) removes repeated decodes.

Every random decision of a batch is drawn in order from the builder's
``np.random.RandomState`` before any decode, so a batch is a function of the
seed alone, draw for draw the JAX package's. Background replacement
(``bg_paths``, with its foreground truncation) and device frame pools
(``pools``) arrive with slice 3b and raise here; depth for RGB-D training
arrives with them.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..engine.batching import dzi_jitter_host
from .bop_data import InstanceRecord, load_image, load_mask


class GdrnTrainLoader:
    """Infinite sampled loader yielding host batch dicts of numpy arrays:
    images (B, H, W, 3) uint8, img_idx, centers, scales, bboxes_xyxy, Ks,
    labels, gt_rots, gt_transes, mask_visib, mask_full (B, H, W) float32,
    mask_idx."""

    def __init__(
        self,
        records: Sequence[InstanceRecord],
        batch_size: int,
        im_width: int,
        im_height: int,
        records2: Optional[Sequence[InstanceRecord]] = None,
        ratio2: float = 0.0,
        dzi_pad_scale: float = 1.5,
        dzi_scale_ratio: float = 0.25,
        dzi_shift_ratio: float = 0.25,
        dzi_type: str = "uniform",
        bbox_type: str = "AMODAL_CLIP",
        seed: int = 0,
        prefetch: int = 2,
        bg_paths: Optional[Sequence[str]] = None,
        sampler: str = "random",       # random | repeat_factor
        repeat_thresh: float = 0.01,
        num_workers: int = -1,         # -1: one decode thread per core
        num_builders: int = 1,
        cache_gb: float = 0.0,
        pools=None,
    ):
        """sampler "repeat_factor" oversamples rare classes (reference
        RepeatFactorTrainingSampler): r(c) = max(1, sqrt(thresh / freq(c))).
        num_builders > 1 builds whole batches in parallel, each builder with
        its own RNG stream (seed + 7919 b), so queue order may interleave."""
        if not records:
            raise ValueError("GdrnTrainLoader needs at least one record")
        if bg_paths:
            raise NotImplementedError("background replacement (bg_paths) arrives with slice 3b")
        if pools is not None:
            raise NotImplementedError("device frame pools arrive with slice 3b")
        self.records = list(records)
        self.records2 = list(records2) if records2 else None
        self.ratio2 = ratio2
        self.batch_size = batch_size
        self.im_w, self.im_h = im_width, im_height
        self.dzi = dict(pad_scale=dzi_pad_scale, scale_ratio=dzi_scale_ratio,
                        shift_ratio=dzi_shift_ratio, dzi_type=dzi_type)
        self.bbox_type = bbox_type
        self._probs = None
        if sampler == "repeat_factor":
            labels = np.array([r.label for r in self.records])
            freq = np.bincount(labels) / max(len(labels), 1)
            r_cls = np.maximum(1.0, np.sqrt(repeat_thresh / np.maximum(freq, 1e-12)))
            w = r_cls[labels]
            self._probs = w / w.sum()
        elif sampler != "random":
            raise ValueError(f"unknown sampler: {sampler}")
        if num_workers < 0:
            num_workers = os.cpu_count() or 1
        self._pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 1 else None
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_budget = int(cache_gb * (1 << 30))
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = []
        for b in range(max(num_builders, 1)):
            rng = np.random.RandomState(seed + 7919 * b)
            th = threading.Thread(target=self._worker, args=(rng,), daemon=True)
            th.start()
            self._threads.append(th)

    def _pick_record(self, rng) -> InstanceRecord:
        if self.records2 and rng.uniform() < self.ratio2:
            return self.records2[rng.randint(len(self.records2))]
        if self._probs is not None:
            return self.records[rng.choice(len(self.records), p=self._probs)]
        return self.records[rng.randint(len(self.records))]

    def _select_bbox(self, rec: InstanceRecord) -> np.ndarray:
        bt = self.bbox_type.upper()
        if bt == "VISIB" or rec.bbox_obj is None:
            b = rec.bbox_visib
        elif bt == "AMODAL":
            b = rec.bbox_obj
        elif bt == "AMODAL_CLIP":
            x1, y1, x2, y2 = rec.bbox_obj
            b = np.array([max(x1, 0), max(y1, 0), min(x2, self.im_w), min(y2, self.im_h)],
                         np.float32)
        else:
            raise ValueError(self.bbox_type)
        if b is None:
            b = np.array([0, 0, self.im_w, self.im_h], np.float32)
        return np.asarray(b, np.float32)

    def _cached(self, key: str, fn) -> np.ndarray:
        """Host-RAM LRU of decoded arrays (shared and read-only: every
        consumer copies them through np.stack)."""
        if self._cache_budget <= 0:
            return fn()
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.cache_hits += 1
                return self._cache[key]
        val = fn()
        val.flags.writeable = False
        with self._cache_lock:
            self.cache_misses += 1
            if key not in self._cache:
                self._cache[key] = val
                self._cache_bytes += val.nbytes
                while self._cache_bytes > self._cache_budget and len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
        return val

    def _fetch_rgb(self, path: str) -> np.ndarray:
        import cv2

        def fn():
            img = load_image(path)
            if img.shape[0] != self.im_h or img.shape[1] != self.im_w:
                img = cv2.resize(img, (self.im_w, self.im_h))
            return img
        return self._cached(path, fn)

    def _fetch_mask(self, path: Optional[str]) -> np.ndarray:
        import cv2

        def fn():
            m = load_mask(path) if path else np.ones((self.im_h, self.im_w), np.float32)
            if m.shape != (self.im_h, self.im_w):
                m = cv2.resize(m, (self.im_w, self.im_h), interpolation=cv2.INTER_NEAREST)
            return m
        return self._cached(path or f"ones:{self.im_w}x{self.im_h}", fn)

    def _load_sample(self, r: InstanceRecord) -> dict:
        """Decode one sample's files (no RNG; runs in the decode threads)."""
        out = {"image": self._fetch_rgb(r.rgb_path)}
        out["mask_visib"] = self._fetch_mask(r.mask_visib_path)
        out["mask_full"] = (self._fetch_mask(r.mask_full_path) if r.mask_full_path
                            else out["mask_visib"])
        return out

    def _build_batch(self, rng) -> dict:
        B = self.batch_size
        recs = [self._pick_record(rng) for _ in range(B)]    # every draw first
        if self._pool is not None:
            samples = list(self._pool.map(self._load_sample, recs))
        else:
            samples = [self._load_sample(r) for r in recs]
        boxes = np.stack([self._select_bbox(r) for r in recs])
        centers, scales = dzi_jitter_host(
            rng, boxes, self.im_w, self.im_h, pad_scale=self.dzi["pad_scale"],
            scale_ratio=self.dzi["scale_ratio"], shift_ratio=self.dzi["shift_ratio"],
            dzi_type=self.dzi["dzi_type"])
        out = {
            "images": np.stack([s["image"] for s in samples]),
            "img_idx": np.arange(B, dtype=np.int32),
            "centers": centers,
            "scales": scales,
            "bboxes_xyxy": boxes,
            "Ks": np.stack([r.K for r in recs]).astype(np.float32),
            "labels": np.asarray([r.label for r in recs], np.int32),
            "gt_rots": np.stack([r.pose[:, :3] for r in recs]).astype(np.float32),
            "gt_transes": np.stack([r.pose[:, 3] for r in recs]).astype(np.float32),
            "mask_visib": np.stack([s["mask_visib"] for s in samples]),
            "mask_full": np.stack([s["mask_full"] for s in samples]),
            "mask_idx": np.arange(B, dtype=np.int32),
        }
        return out

    def _worker(self, rng):
        while not self._stop.is_set():
            try:
                batch = self._build_batch(rng)
            except Exception as e:  # surface loader errors to the consumer
                self._queue.put(e)
                return
            self._queue.put(batch)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the builders (draining the queue so none stays blocked on
        it) and join them, so no thread reads files after this returns."""
        self._stop.set()
        for th in self._threads:
            while th.is_alive():
                try:
                    while True:
                        self._queue.get_nowait()
                except queue_mod.Empty:
                    pass
                th.join(timeout=0.2)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
