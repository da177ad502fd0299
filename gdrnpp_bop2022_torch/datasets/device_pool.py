"""Frame pools on the trainer's device, with delta upload.

Port of ``gdrnpp_bop2022_tpu/datasets/device_pool.py``. Decoded frames stay
on the device across steps in preallocated tensors; the loader uploads only
the frames of a batch that are not already there and ships slot indices.
Training redraws each image ~20x over a run, so the steady state uploads a
few frames a batch.

The JAX package keeps batches consistent by making every upload a new
buffer version. Here a pool is one tensor that uploads overwrite in place,
so the pools track who reads what instead:

  * the loader's (single) builder thread numbers its batches
    (``begin_batch``) and ``ensure`` records, per slot, the newest batch
    that reads it;
  * the trainer calls ``release(seq)`` once it has enqueued every read of
    batch ``seq`` (the gathers of its prep); on the card that records an
    event on the trainer's stream;
  * before an upload overwrites a slot whose newest reader is batch m, the
    builder waits on the host until batch m is released, and on the card
    makes its side stream wait on the event of the newest release (the
    trainer's stream runs in order, so that event follows batch m's
    reads). No upload can overwrite a slot before every batch that reads
    it has read it, and nothing synchronises the device;
  * on the card, uploads run on a side stream from pinned staging copies;
    ``snapshot`` records an event after a batch's uploads, which the
    trainer's stream waits on before it reads the batch.

On the CPU every operation runs when it is called, and the host wait alone
keeps the same order.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class PoolsClosed(RuntimeError):
    """Raised in a builder that waits on a release after the pools closed."""


class DevicePool:
    """One LRU pool of fixed-shape items in a preallocated device tensor.

    ``ensure(keys, fetch)`` returns int32 slots for ``keys``, uploading the
    missing items (``fetch(key) -> np.ndarray``). Slots of the keys in the
    call, and of ``protect``, are never evicted by it."""

    def __init__(self, capacity: int, item_shape: Tuple[int, ...], dtype=torch.uint8,
                 device="cpu", owner: Optional["FramePools"] = None):
        self.capacity = int(capacity)
        self.item_shape = tuple(item_shape)
        self.device = torch.device(device)
        self.buf = torch.zeros((self.capacity,) + self.item_shape, dtype=dtype,
                               device=self.device)
        self._owner = owner
        self._slot: "OrderedDict[object, int]" = OrderedDict()   # key -> slot, LRU order
        self._free = list(range(self.capacity - 1, -1, -1))
        self._reader = [-1] * self.capacity     # per slot, the newest batch reading it
        self.hits = 0
        self.misses = 0

    def __contains__(self, key) -> bool:
        return key in self._slot

    def ensure(self, keys: Sequence, fetch: Callable, protect: Sequence = ()) -> np.ndarray:
        """(len(keys),) int32 slots; uploads the misses. ``protect``: keys
        of a sibling ``ensure`` of the same batch on this pool (visible and
        amodal masks share one), whose slots must survive this call."""
        in_batch = set(keys)
        protected = in_batch | set(protect)
        miss_keys = []
        for k in in_batch:
            if k in self._slot:
                self._slot.move_to_end(k)
                self.hits += 1
            else:
                miss_keys.append(k)
                self.misses += 1
        if miss_keys:
            slots = []
            for k in miss_keys:
                if self._free:
                    s = self._free.pop()
                else:
                    # the least recently used key neither in this batch nor
                    # protected by a sibling call
                    for old in self._slot:
                        if old not in protected:
                            s = self._slot.pop(old)
                            break
                    else:
                        raise RuntimeError(f"DevicePool capacity {self.capacity} smaller "
                                           "than one batch's unique + protected keys")
                self._slot[k] = s
                slots.append(s)
            vals = np.stack([np.asarray(fetch(k)) for k in miss_keys])
            if vals.shape[1:] != self.item_shape:
                raise ValueError(f"pool item {vals.shape[1:]}, expected {self.item_shape}")
            self._upload(slots, vals)
        out = np.asarray([self._slot[k] for k in keys], np.int32)
        if self._owner is not None:
            for s in out.tolist():
                self._reader[s] = self._owner.current
        return out

    def _upload(self, slots, vals: np.ndarray) -> None:
        newest = max(self._reader[s] for s in slots)
        after = None
        if self._owner is not None and newest >= 0:
            after = self._owner.wait_released(newest)
        src = torch.from_numpy(vals).to(self.buf.dtype)
        idx = torch.as_tensor(slots, dtype=torch.long)
        if self.device.type != "cuda":
            self.buf.index_copy_(0, idx, src)
            return
        side = self._owner.stream if self._owner is not None else torch.cuda.current_stream()
        src, idx = src.pin_memory(), idx.pin_memory()
        with torch.cuda.stream(side):
            if after is not None:
                side.wait_event(after)
            self.buf.index_copy_(0, idx.to(self.device, non_blocking=True),
                                 src.to(self.device, non_blocking=True))

    @property
    def nbytes(self) -> int:
        return self.buf.numel() * self.buf.element_size()


class FramePools:
    """The pools of one GDRN training run: RGB frames, masks (visible and
    amodal share one pool, keyed by file), optional depth, optional
    backgrounds; the batch numbering, releases and (on the card) the side
    stream of their uploads."""

    def __init__(self, im_h: int, im_w: int, rgb_frames: int = 512, mask_frames: int = 1024,
                 depth_frames: int = 0, bg_frames: int = 256, device="cpu"):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(device=self.device) if self.device.type == "cuda"
                       else None)
        def mk(n, shape, dtype):
            return DevicePool(n, shape, dtype, self.device, owner=self)
        self.rgb = mk(rgb_frames, (im_h, im_w, 3), torch.uint8)
        self.mask = mk(mask_frames, (im_h, im_w), torch.uint8)
        self.depth = mk(depth_frames, (im_h, im_w), torch.float32) if depth_frames else None
        self.bg = mk(bg_frames, (im_h, im_w, 3), torch.uint8) if bg_frames else None
        if self.stream is not None:         # the zero fills come before any upload
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.current = -1             # the batch being built
        self._released = -1           # the newest batch whose reads are enqueued
        self._release_event = None
        self._closed = False
        self._cond = threading.Condition()

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in (self.rgb, self.mask, self.depth, self.bg)
                   if p is not None)

    def begin_batch(self) -> int:
        """Number the next batch; its ensure() calls follow."""
        self.current += 1
        return self.current

    def snapshot(self) -> Dict[str, object]:
        """What a batch reads, taken after its ensure() calls: the pool
        tensors, its number ``seq``, ``release`` (call it once every read of
        the batch is enqueued) and, on the card, ``ready``, an event after
        its uploads that the reader's stream waits on."""
        out = {"rgb": self.rgb.buf, "mask": self.mask.buf, "seq": self.current,
               "release": functools.partial(self.release, self.current), "ready": None}
        if self.depth is not None:
            out["depth"] = self.depth.buf
        if self.bg is not None:
            out["bg"] = self.bg.buf
        if self.stream is not None:
            out["ready"] = torch.cuda.Event()
            out["ready"].record(self.stream)
        return out

    def release(self, seq: int) -> None:
        """Batch ``seq``'s reads are enqueued (on the caller's stream):
        uploads may overwrite its slots once they are done."""
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        with self._cond:
            self._released = max(self._released, seq)
            self._release_event = ev
            self._cond.notify_all()

    def wait_released(self, seq: int):
        """Block until batch ``seq`` is released; returns the newest
        release's event on the card (None on the CPU)."""
        with self._cond:
            while self._released < seq:
                if self._closed:
                    raise PoolsClosed("frame pools closed while waiting on a release")
                self._cond.wait(timeout=0.1)
            return self._release_event

    def close(self) -> None:
        """Wake and stop any builder waiting on a release."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        out = {"rgb_hits": self.rgb.hits, "rgb_misses": self.rgb.misses,
               "mask_hits": self.mask.hits, "mask_misses": self.mask.misses}
        if self.depth is not None:
            out.update(depth_hits=self.depth.hits, depth_misses=self.depth.misses)
        if self.bg is not None:
            out.update(bg_hits=self.bg.hits, bg_misses=self.bg.misses)
        return out
