"""YOLOX decoupled head and the anchor-free decode.

Port of the serving half of ``gdrnpp_bop2022_tpu/models/yolox/head.py``
(``YOLOXHead`` :25-60, ``flatten_outputs`` :63, ``decode_outputs`` :78,
``_cxcywh_to_xyxy`` :85, ``pairwise_iou`` :90) under the reference's names
(det/yolox/models/yolo_head.py: ``stems``, ``cls_convs``, ``reg_convs``,
``cls_preds``, ``reg_preds``, ``obj_preds``, one entry per level). The
three prediction convs run in fp32 on fp32-cast inputs, as in the JAX
package; the outputs are raw logits (no sigmoid), one (B, H, W, 5 + C)
tensor per level in [reg(4), obj(1), cls(C)] order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from .darknet import BaseConv, DWConv


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int, wid_mul: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 strides: Tuple[int, ...] = (8, 16, 32), depthwise: bool = False,
                 norm: str = "GN", dtype: torch.dtype = torch.bfloat16):
        """in_channels are the neck's output channels (already width-scaled)."""
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        hidden = int(256 * wid_mul)
        Conv = DWConv if depthwise else BaseConv
        kw = dict(norm=norm, dtype=dtype)
        self.stems = nn.ModuleList([BaseConv(c, hidden, 1, **kw) for c in in_channels])
        self.cls_convs = nn.ModuleList([nn.Sequential(Conv(hidden, hidden, 3, **kw),
                                                      Conv(hidden, hidden, 3, **kw))
                                        for _ in in_channels])
        self.reg_convs = nn.ModuleList([nn.Sequential(Conv(hidden, hidden, 3, **kw),
                                                      Conv(hidden, hidden, 3, **kw))
                                        for _ in in_channels])
        self.cls_preds = nn.ModuleList([nn.Conv2d(hidden, num_classes, 1)
                                        for _ in in_channels])
        self.reg_preds = nn.ModuleList([nn.Conv2d(hidden, 4, 1) for _ in in_channels])
        self.obj_preds = nn.ModuleList([nn.Conv2d(hidden, 1, 1) for _ in in_channels])

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            x = self.stems[i](f)
            c = self.cls_convs[i](x).float()
            r = self.reg_convs[i](x).float()
            out = torch.cat([self.reg_preds[i](r), self.obj_preds[i](r),
                             self.cls_preds[i](c)], dim=1)
            outs.append(out.permute(0, 2, 3, 1))
        return outs


def flatten_outputs(outs: Sequence[torch.Tensor], strides: Sequence[int]):
    """Per-level (B, H, W, 5+C) -> (B, A, 5+C), grids (A, 2) as (x, y) and
    the stride of each anchor (A,)."""
    flat, grids, stride_tab = [], [], []
    for o, s in zip(outs, strides):
        B, H, W, C = o.shape
        flat.append(o.reshape(B, H * W, C))
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=o.device),
                                torch.arange(W, dtype=torch.float32, device=o.device),
                                indexing="ij")
        grids.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_tab.append(torch.full((H * W,), float(s), dtype=torch.float32,
                                     device=o.device))
    return torch.cat(flat, 1), torch.cat(grids, 0), torch.cat(stride_tab, 0)


def decode_outputs(flat: torch.Tensor, grids: torch.Tensor, stride_tab: torch.Tensor):
    """Raw (B, A, 5+C) -> boxes cxcywh (B, A, 4), obj logits (B, A), cls
    logits (B, A, C)."""
    st = stride_tab[None, :, None]
    xy = (flat[..., 0:2] + grids[None]) * st
    wh = torch.exp(flat[..., 2:4]) * st
    return torch.cat([xy, wh], -1), flat[..., 4], flat[..., 5:]


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2] - b[..., 2:] * 0.5, b[..., :2] + b[..., 2:] * 0.5], -1)


def pairwise_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    tl = torch.maximum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    br = torch.minimum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a_xyxy[..., 2:] - a_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    area_b = (b_xyxy[..., 2:] - b_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(1e-9)
