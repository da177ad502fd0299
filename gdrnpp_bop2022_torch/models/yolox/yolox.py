"""YOLOX assembly, the static-shape class-aware NMS and test-time augmentation.

Port of ``gdrnpp_bop2022_tpu/models/yolox/yolox.py``: ``YOLOX`` (:31),
``_SIZES`` and ``build_yolox`` (:22, :55), ``make_tta_inference`` (:63),
``tta_inference`` (:120) and ``postprocess_nms`` (:132), under the
reference's module names (det/yolox/models/yolox.py: ``backbone`` = the
PAFPN, ``head``).

The NMS keeps the JAX package's shapes: the top ``k = min(4 max_dets, A)``
candidates by score, greedy suppression among them, compaction to
``min(max_dets, k)`` rows with a ``valid`` mask. The greedy scan runs on
the device as a fixed point over all images at once: kept[j] = (score[j] >
0) and no kept i < j of the same class overlaps j above ``nms_thr``. That
recursion has one solution, the greedy one, and after t steps from "all
kept" the first t candidates hold it, so iterating until nothing changes
gives the sequential scan's result exactly; the number of steps is the
longest chain of suppressions (a few), checked on the host once every
``NMS_CHECK_EVERY`` steps.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .head import YOLOXHead, cxcywh_to_xyxy, decode_outputs, flatten_outputs, pairwise_iou
from .pafpn import YOLOPAFPN

_SIZES = {
    # name: (depth_mul, width_mul)
    "yolox_s": (0.33, 0.50),
    "yolox_m": (0.67, 0.75),
    "yolox_l": (1.0, 1.0),
    "yolox_x": (1.33, 1.25),
}

STRIDES = (8, 16, 32)
# fixed-point steps of the NMS between two host checks for convergence
NMS_CHECK_EVERY = 4


class YOLOX(nn.Module):
    def __init__(self, num_classes: int, dep_mul: float = 1.33, wid_mul: float = 1.25,
                 strides: Tuple[int, ...] = STRIDES, depthwise: bool = False,
                 norm: str = "GN", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = YOLOPAFPN(dep_mul, wid_mul, depthwise, norm=norm, dtype=dtype)
        self.head = YOLOXHead(num_classes, wid_mul, self.backbone.out_channels, strides,
                              depthwise, norm=norm, dtype=dtype)
        self.strides = tuple(strides)

    def forward(self, images: torch.Tensor):
        """images (B, H, W, 3) float as the letterbox gives them (0..255).
        Returns the raw per-level outputs [(B, H/s, W/s, 5 + C)], fp32."""
        # NCHW in contiguous memory: at batch 8 and 640x640 on an H100 the
        # forward takes 27.1 / 23.1 ms (GN / BN) against 28.4 / 25.0 ms in
        # channels_last (GroupNorm's CUDA kernel returns contiguous NCHW anyway)
        return self.head(self.backbone(images.permute(0, 3, 1, 2).contiguous()))


def build_yolox(num_classes: int, size: str = "yolox_x", norm: str = "GN",
                device="cuda", dtype: torch.dtype = torch.bfloat16,
                depthwise: bool = False) -> YOLOX:
    """YOLOX of ``size`` on ``device`` (the card unless the caller asks for
    the CPU), in eval mode (BN uses its running statistics)."""
    d, w = _SIZES[size]
    model = YOLOX(num_classes, d, w, depthwise=depthwise, norm=norm, dtype=dtype)
    return model.to(device).eval()


def _greedy_keep(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """suppress (B, k, k): i suppresses j if kept (i < j only); valid (B, k).
    Returns the greedy scan's kept mask (B, k)."""
    kept = valid
    for _ in range(0, valid.shape[-1] + 1, NMS_CHECK_EVERY):
        for _ in range(NMS_CHECK_EVERY):
            prev, kept = kept, valid & ~(suppress & kept[..., :, None]).any(-2)
        if torch.equal(prev, kept):
            break
    return kept


def postprocess_nms(outs_flat: torch.Tensor, grids: torch.Tensor, stride_tab: torch.Tensor,
                    conf_thr: float = 0.01, nms_thr: float = 0.65,
                    max_dets: int = 100) -> Dict[str, torch.Tensor]:
    """Class-aware greedy NMS with static shapes.

    Returns boxes_xyxy (B, D, 4), scores (B, D) (0 where not kept), labels
    (B, D) and valid (B, D), D = min(max_dets, 4 max_dets, A); kept rows come
    first, in score order.
    """
    boxes, obj_logit, cls_logit = decode_outputs(outs_flat, grids, stride_tab)
    scores_all = torch.sigmoid(obj_logit)[..., None] * torch.sigmoid(cls_logit)
    cls_conf = scores_all.amax(-1)
    cls_id = scores_all.argmax(-1)
    score = torch.where(cls_conf > conf_thr, cls_conf, torch.zeros_like(cls_conf))

    k = min(max_dets * 4, score.shape[1])
    top_s, top_i = torch.topk(score, k, dim=1)
    top_b = cxcywh_to_xyxy(torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)))
    top_c = torch.gather(cls_id, 1, top_i)
    iou = pairwise_iou(top_b, top_b)
    earlier = torch.ones(k, k, dtype=torch.bool, device=score.device).triu(1)
    suppress = (iou > nms_thr) & (top_c[:, :, None] == top_c[:, None, :]) & earlier
    kept = _greedy_keep(suppress, top_s > 0)
    # kept first; the stable sort keeps score order within each group
    sel = torch.argsort((~kept).to(torch.uint8), dim=1, stable=True)[:, :max_dets]
    kept_sel = torch.gather(kept, 1, sel)
    s_sel = torch.gather(top_s, 1, sel)
    return {"boxes_xyxy": torch.gather(top_b, 1, sel[..., None].expand(-1, -1, 4)),
            "scores": torch.where(kept_sel, s_sel, torch.zeros_like(s_sel)),
            "labels": torch.gather(top_c, 1, sel),
            "valid": kept_sel}


def make_inference(model: YOLOX, conf_thr: float = 0.01, nms_thr: float = 0.65,
                   max_dets: int = 100):
    """run(images (B, H, W, 3)) -> postprocess_nms's dict: one forward, the
    decode and the NMS (the JAX CLIs' jitted ``infer``)."""
    @torch.inference_mode()
    def run(images):
        flat, grids, st = flatten_outputs(model(images), model.strides)
        return postprocess_nms(flat, grids, st, conf_thr=conf_thr, nms_thr=nms_thr,
                               max_dets=max_dets)
    return run


def resize_bilinear(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) fp32 as ``jax.image.resize(images,
    (B, h, w, C), "bilinear")``: half-pixel centres, the triangle kernel
    widened by 1/scale when downscaling (antialias), unchanged when the size
    is. ``F.interpolate(antialias=True)`` computes that function
    (``tests/test_torch_yolox_tta.py`` holds it to JAX at the borders too)."""
    x = images.float()
    if (x.shape[1], x.shape[2]) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def tta_sizes(H: int, W: int, scales: Sequence[float]):
    """Each scale's input size, rounded to a multiple of 32."""
    return [(int(round(H * s / 32)) * 32, int(round(W * s / 32)) * 32) for s in scales]


def tta_rows(model: YOLOX, images: torch.Tensor, scales=(0.75, 1.0, 1.25),
             flip: bool = True) -> torch.Tensor:
    """The raw rows of every test-time variant of images (B, H, W, 3): each
    scale (rounded to a multiple of 32) and its horizontal flip, re-encoded
    at the base resolution so that they decode with grid 0 and stride 1
    (xy = the box centre, wh = its log size). (B, sum of A, 5 + C)."""
    H, W = images.shape[1], images.shape[2]
    parts = []
    for h, w in tta_sizes(H, W, scales):
        for flipped in (False, True) if flip else (False,):
            img = resize_bilinear(images, h, w)
            if flipped:
                img = img.flip(2)
            flat, grids, st = flatten_outputs(model(img), model.strides)
            boxes, _, _ = decode_outputs(flat, grids, st)
            x = w - boxes[..., 0] if flipped else boxes[..., 0]
            xy = torch.stack([x * (W / w), boxes[..., 1] * (H / h)], -1)
            wh = boxes[..., 2:4] * torch.tensor([W / w, H / h], dtype=torch.float32,
                                                device=flat.device)
            parts.append(torch.cat([xy, torch.log(wh.clamp_min(1e-6)), flat[..., 4:]], -1))
    return torch.cat(parts, 1)


def make_tta_inference(model: YOLOX, scales=(0.75, 1.0, 1.25), flip: bool = True,
                       conf_thr: float = 0.01, nms_thr: float = 0.65, max_dets: int = 100):
    """Test-time augmentation (reference det/yolox/models/yolox.py:53):
    run(images (B, H, W, 3)) runs every variant of ``tta_rows`` and one
    joint NMS over all of them."""
    @torch.inference_mode()
    def run(images):
        flat = tta_rows(model, images, scales, flip)
        A = flat.shape[1]
        grids = torch.zeros(A, 2, dtype=torch.float32, device=flat.device)
        st = torch.ones(A, dtype=torch.float32, device=flat.device)
        return postprocess_nms(flat, grids, st, conf_thr=conf_thr, nms_thr=nms_thr,
                               max_dets=max_dets)

    return run


def tta_inference(model: YOLOX, images: torch.Tensor, scales=(0.75, 1.0, 1.25),
                  flip: bool = True, conf_thr: float = 0.01, nms_thr: float = 0.65,
                  max_dets: int = 100):
    """One-shot ``make_tta_inference``."""
    return make_tta_inference(model, scales=scales, flip=flip, conf_thr=conf_thr,
                              nms_thr=nms_thr, max_dets=max_dets)(images)
