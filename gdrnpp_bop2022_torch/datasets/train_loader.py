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
``np.random.RandomState`` before any decode (the records, one background
per sample, the truncation's two uniforms per sample), so a batch is a
function of the seed alone, draw for draw the JAX package's. With
``bg_paths`` a batch carries one background per sample (aspect-preserving
centre crop and resize) and the foreground masks the trainer composites
with (visible masks, truncated on the host with ``truncate_fg``); with
``with_depth`` the depth in meters. With ``pools`` (``device_pool.FramePools``)
a batch carries slot indices into frames kept on the device instead of
stacked pixels, and the truncation's draws instead of truncated masks.
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
from .bop_data import InstanceRecord, load_depth, load_image, load_mask


class GdrnTrainLoader:
    """Infinite sampled loader yielding host batch dicts of numpy arrays:
    images (B, H, W, 3) uint8, img_idx, centers, scales, bboxes_xyxy, Ks,
    labels, gt_rots, gt_transes, mask_visib, mask_full (B, H, W) float32,
    mask_idx; with depth, depths (B, H, W) float32 meters; with
    backgrounds, bg_images (B, H, W, 3) uint8 and fg_masks (B, H, W)
    float32. In pool mode: pool_mode, img_idx / mask_idx / mask_full_idx
    (/ depth_idx / bg_idx) slots, trunc_draws (B, 2) float32 with
    truncation, the small per-sample arrays and pool_bufs (the pools'
    snapshot)."""

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
        truncate_fg: bool = False,
        with_depth: bool = False,
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
        its own RNG stream (seed + 7919 b), so queue order may interleave.
        bg_paths: background images (reference _bg_img_paths,
        base_data_loader.py:339-460), one drawn per sample per batch;
        truncate_fg: randomly truncate the foreground before replacement
        (reference trunc_mask, base_data_loader.py:454-478). Pool mode takes
        one builder: its slot assignment is stateful."""
        if not records:
            raise ValueError("GdrnTrainLoader needs at least one record")
        if pools is not None and num_builders > 1:
            raise ValueError("pool mode takes num_builders=1")
        self.pools = pools
        self._bg_paths = list(bg_paths) if bg_paths else None
        self.truncate_fg = truncate_fg
        self.with_depth = with_depth
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

    def _fetch_depth(self, r: InstanceRecord) -> np.ndarray:
        """Depth in meters (reference data_loader.py:345-349); zeros where
        the record has none."""
        import cv2

        def fn():
            if r.depth_path:
                d = load_depth(r.depth_path, r.depth_scale, 1000.0)
            else:
                d = np.zeros((self.im_h, self.im_w), np.float32)
            if d.shape != (self.im_h, self.im_w):
                d = cv2.resize(d, (self.im_w, self.im_h), interpolation=cv2.INTER_NEAREST)
            return d
        return self._cached(r.depth_path or f"zd:{r.rgb_path}", fn)

    def _fetch_mask(self, path: Optional[str]) -> np.ndarray:
        import cv2

        def fn():
            m = load_mask(path) if path else np.ones((self.im_h, self.im_w), np.float32)
            if m.shape != (self.im_h, self.im_w):
                m = cv2.resize(m, (self.im_w, self.im_h), interpolation=cv2.INTER_NEAREST)
            return m
        return self._cached(path or f"ones:{self.im_w}x{self.im_h}", fn)

    def _fetch_bg(self, path: str) -> np.ndarray:
        return self._cached(f"bg:{path}", lambda: self._load_bg(path))

    def _load_bg(self, path: str) -> np.ndarray:
        """One background, aspect-preserving centre crop then resize
        (reference get_bg_image, base_data_loader.py:480-520); zeros for a
        missing file, as the JAX package does."""
        import cv2
        try:
            img = load_image(path)
        except FileNotFoundError:
            return np.zeros((self.im_h, self.im_w, 3), np.uint8)
        h, w = img.shape[:2]
        target_ar = self.im_w / self.im_h
        if w / h > target_ar:      # too wide: crop the width
            cw = max(int(h * target_ar), 1)
            x0 = (w - cw) // 2
            img = img[:, x0:x0 + cw]
        else:                      # too tall: crop the height
            ch = max(int(w / target_ar), 1)
            y0 = (h - ch) // 2
            img = img[y0:y0 + ch]
        return cv2.resize(img, (self.im_w, self.im_h))

    @staticmethod
    def _trunc_mask(mask: np.ndarray, draws: np.ndarray) -> np.ndarray:
        """Blank one side of the foreground's box (reference trunc_mask,
        base_data_loader.py:454-478). draws: the two pre-drawn uniforms
        (branch, cut position), so the cut is a function of (mask, draws)
        and ``engine.batching.trunc_mask_batch`` makes the same one."""
        m = mask.astype(bool).copy()
        nz = np.nonzero(m)
        if len(nz[0]) == 0:
            return m.astype(np.float32)
        x1, y1 = np.min(nz[0]), np.min(nz[1])
        x2, y2 = np.max(nz[0]), np.max(nz[1])
        c_h, c_w = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
        rnd, u = float(draws[0]), float(draws[1])
        if rnd < 0.2:
            m[:int(x1 + u * (c_h - x1)), :] = False
        elif rnd < 0.4:
            m[int(c_h + u * (x2 - c_h)):, :] = False
        elif rnd < 0.6:
            m[:, :int(y1 + u * (c_w - y1))] = False
        elif rnd < 0.8:
            m[:, int(c_w + u * (y2 - c_w)):] = False
        return m.astype(np.float32)

    def _load_sample(self, r: InstanceRecord, bg_path: Optional[str]) -> dict:
        """Decode one sample's files (no RNG; runs in the decode threads)."""
        out = {"image": self._fetch_rgb(r.rgb_path)}
        if self.with_depth:
            out["depth"] = self._fetch_depth(r)
        out["mask_visib"] = self._fetch_mask(r.mask_visib_path)
        out["mask_full"] = (self._fetch_mask(r.mask_full_path) if r.mask_full_path
                            else out["mask_visib"])
        if bg_path is not None:
            out["bg"] = self._fetch_bg(bg_path)
        return out

    def _dzi(self, rng, recs):
        boxes = np.stack([self._select_bbox(r) for r in recs])
        centers, scales = dzi_jitter_host(
            rng, boxes, self.im_w, self.im_h, pad_scale=self.dzi["pad_scale"],
            scale_ratio=self.dzi["scale_ratio"], shift_ratio=self.dzi["shift_ratio"],
            dzi_type=self.dzi["dzi_type"])
        return boxes, centers, scales

    @staticmethod
    def _per_sample(recs) -> dict:
        return {"Ks": np.stack([r.K for r in recs]).astype(np.float32),
                "labels": np.asarray([r.label for r in recs], np.int32),
                "gt_rots": np.stack([r.pose[:, :3] for r in recs]).astype(np.float32),
                "gt_transes": np.stack([r.pose[:, 3] for r in recs]).astype(np.float32)}

    def _build_batch(self, rng) -> dict:
        B = self.batch_size
        # every draw first: records, backgrounds, truncation uniforms
        recs = [self._pick_record(rng) for _ in range(B)]
        bg_sel = (None if self._bg_paths is None else
                  [self._bg_paths[rng.randint(len(self._bg_paths))] for _ in range(B)])
        trunc_draws = (rng.uniform(size=(B, 2))
                       if self._bg_paths is not None and self.truncate_fg else None)
        if self.pools is not None:
            return self._finish_pool_batch(rng, recs, bg_sel, trunc_draws)
        bgs = bg_sel if bg_sel is not None else [None] * B
        if self._pool is not None:
            samples = list(self._pool.map(self._load_sample, recs, bgs))
        else:
            samples = [self._load_sample(r, b) for r, b in zip(recs, bgs)]
        boxes, centers, scales = self._dzi(rng, recs)
        out = {
            "images": np.stack([s["image"] for s in samples]),
            "img_idx": np.arange(B, dtype=np.int32),
            "centers": centers,
            "scales": scales,
            "bboxes_xyxy": boxes,
            **self._per_sample(recs),
            "mask_visib": np.stack([s["mask_visib"] for s in samples]),
            "mask_full": np.stack([s["mask_full"] for s in samples]),
            "mask_idx": np.arange(B, dtype=np.int32),
        }
        if self.with_depth:
            out["depths"] = np.stack([s["depth"] for s in samples])
        if self._bg_paths is not None:
            out["bg_images"] = np.stack([s["bg"] for s in samples])
            out["fg_masks"] = (np.stack([self._trunc_mask(s["mask_visib"], d)
                                         for s, d in zip(samples, trunc_draws)])
                               if self.truncate_fg else out["mask_visib"])
        return out

    def _finish_pool_batch(self, rng, recs, bg_sel, trunc_draws) -> dict:
        """Pool mode: upload only the frames not on the device and ship
        slot indices and the small per-sample arrays; the truncation moves
        to the device (``engine.batching.trunc_mask_batch``, the same
        draws). The batch's content is a function of the rng stream; only
        its slot numbers depend on the pools' history."""
        pools = self.pools
        pools.begin_batch()
        if self._pool is not None:       # decode the misses in parallel into the cache
            miss = [p for p in {r.rgb_path for r in recs} if p not in pools.rgb]
            list(self._pool.map(self._fetch_rgb, miss))
            if self.with_depth and pools.depth is not None:
                by_key = {(r.depth_path or f"zd:{r.rgb_path}"): r for r in recs}
                list(self._pool.map(self._fetch_depth, [r for k, r in by_key.items()
                                                        if k not in pools.depth]))
        img_idx = pools.rgb.ensure([r.rgb_path for r in recs], self._fetch_rgb)

        def fetch_mask_u8(key):
            m = self._fetch_mask(None if key.startswith("ones:") else key)
            return (m > 0.5).astype(np.uint8)

        mv_keys = [r.mask_visib_path or f"ones:{self.im_w}x{self.im_h}" for r in recs]
        mf_keys = [r.mask_full_path or k for r, k in zip(recs, mv_keys)]
        # visible and amodal masks share a pool: each call protects the
        # other's keys, or the second could evict what the first assigned
        mask_idx = pools.mask.ensure(mv_keys, fetch_mask_u8, protect=mf_keys)
        mask_full_idx = pools.mask.ensure(mf_keys, fetch_mask_u8, protect=mv_keys)
        boxes, centers, scales = self._dzi(rng, recs)
        out = {"pool_mode": True, "img_idx": img_idx, "mask_idx": mask_idx,
               "mask_full_idx": mask_full_idx, "centers": centers, "scales": scales,
               "bboxes_xyxy": boxes, **self._per_sample(recs)}
        if self.with_depth:
            if pools.depth is None:
                raise ValueError("pool mode with depth needs depth frames in the pools")
            dkeys = [r.depth_path or f"zd:{r.rgb_path}" for r in recs]
            by_dkey = dict(zip(dkeys, recs))
            out["depth_idx"] = pools.depth.ensure(dkeys, lambda k: self._fetch_depth(by_dkey[k]))
        if self._bg_paths is not None:
            if pools.bg is None:
                raise ValueError("pool mode with backgrounds needs bg frames in the pools")
            out["bg_idx"] = pools.bg.ensure(bg_sel, self._fetch_bg)
            if self.truncate_fg:
                out["trunc_draws"] = trunc_draws.astype(np.float32)
        # after every ensure: the reader gathers from these buffers once
        # this batch's uploads are done
        out["pool_bufs"] = pools.snapshot()
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
        it, waking one that waits on a pool release) and join them, so no
        thread reads files after this returns."""
        self._stop.set()
        if self.pools is not None:
            self.pools.close()
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
