"""YOLOX decoupled head, the anchor-free decode, simOTA and the YOLOX loss.

Port of ``gdrnpp_bop2022_tpu/models/yolox/head.py`` (``YOLOXHead`` :25-60,
``flatten_outputs`` :63, ``decode_outputs`` :78, ``_cxcywh_to_xyxy`` :85,
``pairwise_iou`` :90, ``_bce_logits`` :101, ``simota_assign`` :106,
``yolox_loss`` :177) under the reference's names
(det/yolox/models/yolo_head.py: ``stems``, ``cls_convs``, ``reg_convs``,
``cls_preds``, ``reg_preds``, ``obj_preds``, one entry per level). The
three prediction convs run in fp32 on fp32-cast inputs, as in the JAX
package; the outputs are raw logits (no sigmoid), one (B, H, W, 5 + C)
tensor per level in [reg(4), obj(1), cls(C)] order.

simOTA keeps the JAX package's static shapes (every anchor against every
padded GT, invalid pairs at +inf cost, dynamic k as "among the k cheapest"
by a stable sort) batched over the images, and runs under ``no_grad``: only
which anchor goes with which GT leaves it. The IoU of each foreground
anchor with its GT, the classification target's weight, is recomputed
elementwise with its gradient, as the JAX loss lets ``jax.grad`` through it
(the reference detaches its whole assignment).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ...parallel.distributed import global_sum, world_size
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
    return box_iou(a_xyxy[..., :, None, :], b_xyxy[..., None, :, :])


def box_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) x (..., 4) -> (...) IoU of the rows, broadcast."""
    tl = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    br = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a_xyxy[..., 2:] - a_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    area_b = (b_xyxy[..., 2:] - b_xyxy[..., :2]).clamp_min(0.0).prod(-1)
    return inter / (area_a + area_b - inter).clamp_min(1e-9)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the JAX ``_bce_logits``)."""
    return logits.clamp_min(0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


@torch.no_grad()
def simota_match(boxes_dec, obj_logit, cls_logit, grids, stride_tab, gt_boxes, gt_labels,
                 gt_valid, center_radius: float = 2.5, topk_candidates: int = 10):
    """Static-shape simOTA over a batch: boxes_dec (B, A, 4) cxcywh,
    obj_logit (B, A), cls_logit (B, A, C), grids (A, 2), stride_tab (A,),
    gt_boxes (B, G, 4) cxcywh, gt_labels (B, G), gt_valid (B, G) bool.
    Returns fg (B, A) bool and matched_gt (B, A) int64 (0 where not fg)."""
    B, A, _ = boxes_dec.shape
    G = gt_boxes.shape[1]
    boxes_dec, obj_logit, cls_logit = boxes_dec.float(), obj_logit.float(), cls_logit.float()
    centers = (grids + 0.5) * stride_tab[:, None]                         # (A, 2)
    cx, cy = centers[None, :, None, 0], centers[None, :, None, 1]          # (1, A, 1)
    gt_xyxy = cxcywh_to_xyxy(gt_boxes)[:, None]                            # (B, 1, G, 4)
    in_box = ((cx >= gt_xyxy[..., 0]) & (cx <= gt_xyxy[..., 2])
              & (cy >= gt_xyxy[..., 1]) & (cy <= gt_xyxy[..., 3]))        # (B, A, G)
    cr = center_radius * stride_tab[None, :, None]
    in_center = (((cx - gt_boxes[:, None, :, 0]).abs() < cr)
                 & ((cy - gt_boxes[:, None, :, 1]).abs() < cr))
    valid = gt_valid[:, None, :]
    candidate = (in_box | in_center) & valid
    both = in_box & in_center

    ious = pairwise_iou(cxcywh_to_xyxy(boxes_dec), gt_xyxy[:, 0])         # (B, A, G)
    ious = torch.where(valid, ious, 0.0)
    # BCE(sqrt(cls_prob obj_prob), onehot) summed over classes, without the
    # (B, A, G, C) tensor: sum_c log(1 - p) less the GT class's term, plus
    # its log p
    p = torch.sqrt((torch.sigmoid(cls_logit) * torch.sigmoid(obj_logit)[..., None])
                   .clamp(1e-8, 1.0))                                      # (B, A, C)
    logp = torch.log(p)
    log1mp = torch.log((1.0 - p).clamp(1e-8, 1.0))
    lab = gt_labels.long()[:, None, :].expand(B, A, G)
    cls_cost = -(torch.gather(logp, 2, lab) + log1mp.sum(-1, keepdim=True)
                 - torch.gather(log1mp, 2, lab))
    cost = cls_cost + 3.0 * -torch.log(ious + 1e-8) + 100000.0 * (~both)
    cost = torch.where(candidate, cost, torch.inf)

    # dynamic k per GT from the top-10 candidate IoUs (at most K = 10), and
    # the k cheapest anchors of each GT (ties go to the lower index)
    K = min(topk_candidates, A)
    topk_ious = torch.topk(torch.where(candidate, ious, 0.0), K, dim=1).values
    dynamic_ks = topk_ious.sum(1).to(torch.int32).clamp_min(1)             # (B, G)
    order = torch.argsort(cost, dim=1, stable=True)[:, :K]                 # (B, K, G)
    first_k = torch.arange(K, device=cost.device)[None, :, None] < dynamic_ks[:, None, :]
    matching = torch.zeros_like(candidate).scatter_(1, order, first_k) & torch.isfinite(cost)

    # conflicts: an anchor matched to several GTs keeps its cheapest
    n_match = matching.sum(-1)
    best_gt = torch.where(matching, cost, torch.inf).argmin(-1)
    keep = (torch.nn.functional.one_hot(best_gt, G).bool() & (n_match[..., None] > 0))
    matching = torch.where((n_match > 1)[..., None], keep, matching)
    return matching.any(-1), matching.to(torch.uint8).argmax(-1)


def simota_assign(boxes_dec, obj_logit, cls_logit, grids, stride_tab, gt_boxes, gt_labels,
                  gt_valid, center_radius: float = 2.5, topk_candidates: int = 10):
    """The JAX ``simota_assign`` over a batch (shapes as ``simota_match``).
    Returns fg (B, A), matched_gt (B, A) and matched_iou (B, A): each
    anchor's IoU with its matched GT (0 for a padded one), differentiable
    in boxes_dec."""
    fg, matched_gt = simota_match(boxes_dec, obj_logit, cls_logit, grids, stride_tab,
                                  gt_boxes, gt_labels, gt_valid, center_radius,
                                  topk_candidates)
    tgt = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(-1, -1, 4))
    iou = box_iou(cxcywh_to_xyxy(boxes_dec), cxcywh_to_xyxy(tgt))
    return fg, matched_gt, torch.where(torch.gather(gt_valid, 1, matched_gt), iou, 0.0)


def yolox_loss(outs: Sequence[torch.Tensor], strides: Sequence[int], gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor,
               use_l1: bool = False) -> Dict[str, torch.Tensor]:
    """The YOLOX training loss (reference get_losses, yolo_head.py:256-430)
    on the raw per-level outputs, in fp32: IoU loss x 5 and class BCE over
    the foreground, objectness BCE over every anchor, and with ``use_l1``
    the L1 loss on the raw regression targets; each over the foreground
    count. gt_boxes (B, G, 4) cxcywh pixels, gt_labels (B, G), gt_valid
    (B, G). Returns loss_iou, loss_obj, loss_cls (, loss_l1), total_loss and
    num_fg_per_img as 0-d tensors."""
    flat, grids, stride_tab = flatten_outputs([o.float() for o in outs], strides)
    boxes_dec, obj_logit, cls_logit = decode_outputs(flat, grids, stride_tab)
    gt_boxes = gt_boxes.float()
    # matched_iou keeps its gradient: the class target is not stopped
    fg, matched_gt, matched_iou = simota_assign(boxes_dec, obj_logit, cls_logit, grids,
                                                stride_tab, gt_boxes, gt_labels, gt_valid)
    B = fg.shape[0]
    fgf = fg.float()
    # the global batch's foreground count under data parallelism, each sum
    # scaled by the world size (parallel/distributed.py); 1 and fgf.sum()
    # in a world of one
    num_fg = global_sum(fgf.sum()).clamp_min(1.0) / world_size()
    tgt_labels = torch.gather(gt_labels.long(), 1, matched_gt)

    # a foreground anchor's GT is valid: there matched_iou is its IoU
    loss_iou = ((1.0 - matched_iou ** 2) * fgf).sum() / num_fg
    loss_obj = bce_logits(obj_logit, fgf).sum() / num_fg
    onehot = torch.nn.functional.one_hot(tgt_labels, cls_logit.shape[-1]).float()
    cls_tgt = onehot * matched_iou[..., None]
    loss_cls = (bce_logits(cls_logit, cls_tgt) * fgf[..., None]).sum() / num_fg

    losses = {"loss_iou": 5.0 * loss_iou, "loss_obj": loss_obj, "loss_cls": loss_cls}
    if use_l1:
        st = stride_tab[None]
        tgt_boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(-1, -1, 4))
        tgt_raw = torch.stack([tgt_boxes[..., 0] / st - grids[None, :, 0],
                               tgt_boxes[..., 1] / st - grids[None, :, 1],
                               torch.log((tgt_boxes[..., 2] / st).clamp_min(1e-8)),
                               torch.log((tgt_boxes[..., 3] / st).clamp_min(1e-8))], -1)
        losses["loss_l1"] = ((flat[..., :4] - tgt_raw).abs() * fgf[..., None]).sum() / num_fg
    losses["total_loss"] = sum(losses.values())
    losses["num_fg_per_img"] = fgf.sum() / B
    return losses
