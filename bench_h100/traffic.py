"""Traffic: a pool of test frames and their detections, packed into host batches.

A mix (``traffic/<name>.json``) gives the number of frames in the pool, how
many detections each frame has (a fixed multiset: every seed serves the same
set of sizes, in another order), the batch geometry of the serving loop and
the number of batches the pool must pack into. The seed draws the frames'
order and content. Frames are packed as the serving loader
(``iter_test_batches``) packs them: frames in order, a frame's ROIs never
split, a batch flushed when the next frame's ROIs would pass ``batch_size``
ROI slots or it needs a new image slot past ``images_per_batch``; ROI slots
are padded by repeating the last real ROI (``valid`` False), image slots by
zero frames.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from .scene import make_frames

# the fields the serving loop reads from each ROI's entry in "metas"
RoiMeta = namedtuple("RoiMeta", "scene_id im_id obj_id score det_time")

SCENE_ID = 48           # YCB-V's first test scene
MAX_ORDERS = 1000


def frame_counts(mix: dict) -> list:
    counts = [int(n) for n, k in sorted(mix["dets_per_frame"].items(), key=lambda e: int(e[0]))
              for _ in range(k)]
    if len(counts) != mix["frames"]:
        raise ValueError(f"dets_per_frame holds {len(counts)} frames, not {mix['frames']}")
    return counts


def pack(counts, batch_size: int, images_per_batch: int):
    """Frame indices of each batch, frames taken in order."""
    batches, cur, rois = [], [], 0
    for f, n in enumerate(counts):
        if n > batch_size:
            raise ValueError(f"a frame of {n} ROIs does not fit a batch of {batch_size}")
        if cur and (rois + n > batch_size or len(cur) >= images_per_batch):
            batches.append(cur)
            cur, rois = [], 0
        cur.append(f)
        rois += n
    if cur:
        batches.append(cur)
    return batches


def frame_order(mix: dict, rng: np.random.Generator):
    """A permutation of the mix's frame counts that packs into exactly
    ``mix["batches"]`` batches (the first of up to MAX_ORDERS draws)."""
    counts = np.asarray(frame_counts(mix))
    for _ in range(MAX_ORDERS):
        order = rng.permutation(len(counts))
        if len(pack(counts[order], mix["batch_size"], mix["images_per_batch"])) == mix["batches"]:
            return [int(c) for c in counts[order]]
    raise ValueError(f"no order of the mix packs into {mix['batches']} batches")


def host_batch(frames, images, depths, dets, K, batch_size: int, images_per_batch: int):
    """One batch in the serving loop's format (``iter_test_batches``)."""
    rois = [(slot, f, d) for slot, f in enumerate(frames) for d in dets[f]]
    n = len(rois)
    rois += [rois[-1]] * (batch_size - n)
    h, w = images.shape[1:3]
    imgs = np.zeros((images_per_batch, h, w, 3), np.uint8)
    imgs[:len(frames)] = images[frames]
    batch = {
        "images": imgs,
        "img_idx": np.array([slot for slot, _, _ in rois], np.int32),
        "boxes_xyxy": np.stack([d["bbox_xyxy"] for _, _, d in rois]).astype(np.float32),
        "Ks": np.tile(np.asarray(K, np.float32), (batch_size, 1, 1)),
        "labels": np.array([d["label"] for _, _, d in rois], np.int32),
        "scores": np.array([d["score"] for _, _, d in rois], np.float32),
        "valid": np.arange(batch_size) < n,
        "metas": [RoiMeta(SCENE_ID, f, d["obj_id"], d["score"], 0.0) for _, f, d in rois],
    }
    if depths is not None:
        deps = np.zeros((images_per_batch, h, w), np.float32)
        deps[:len(frames)] = depths[frames]
        batch["depths"] = deps
    return batch


def make_pool(mix: dict, scene: dict, axes: np.ndarray, seed: int, gen, device,
              with_depth: bool):
    """The seed's pool: host batches in the serving loop's format."""
    counts = frame_order(mix, np.random.default_rng(seed))
    images, depths, dets = make_frames(gen, counts, scene, axes, device)
    packed = pack(counts, mix["batch_size"], mix["images_per_batch"])
    return [host_batch(fr, images, depths if with_depth else None, dets, scene["K"],
                       mix["batch_size"], mix["images_per_batch"]) for fr in packed]
