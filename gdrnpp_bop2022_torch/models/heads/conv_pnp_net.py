"""Patch-PnP head: learned PnP over dense coordinate features.

Port of ``gdrnpp_bop2022_tpu/models/heads/conv_pnp_net.py`` (``ConvPnPNet``
and the class-aware ``ConvPnPNetCls``) with the reference's names:
``features`` holds [conv, norm, act] triplets (stride-2 convs, then extra
stride-1 convs), followed by ``fc1``, ``fc2``, ``fc_r`` and ``fc_t``. The
norm is GroupNorm, flax's LayerNorm (eps 1e-6, fp32 output) or none, as the
JAX ``get_norm`` gives. The flatten is NCHW (channel-major) as in the
reference; the JAX package flattens NHWC and permutes ``fc1`` instead.
Convs and fc1/fc2 run in the compute dtype, fc_r/fc_t in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..layers import Act, DropBlock2D, DropMasks, conv2d, get_act, get_norm, linear


def final_spatial(output_res: int, num_stride2_layers: int) -> int:
    """Side of the map after the stride-2 convs (k3, p1: ceil(H / 2) each)."""
    s = output_res
    for _ in range(num_stride2_layers):
        s = (s + 1) // 2
    return s


class ConvPnPNet(nn.Module):
    def __init__(self, in_channels: int, featdim: int = 128, rot_dim: int = 6,
                 num_stride2_layers: int = 3, num_extra_layers: int = 0,
                 norm: str = "GN", num_gn_groups: int = 32, act: str = "gelu",
                 drop_prob: float = 0.0, dropblock_size: int = 5,
                 flat_op: str = "flatten", denormalize_by_extent: bool = True,
                 mask_attention: str = "none", output_res: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.featdim = featdim
        self.flat_op = flat_op
        self.denormalize_by_extent = denormalize_by_extent
        self.mask_attention = mask_attention
        self.dropblock = DropBlock2D(drop_prob, dropblock_size)
        layers = []
        c = in_channels
        for i in range(num_stride2_layers + num_extra_layers):
            stride = 2 if i < num_stride2_layers else 1
            layers += [nn.Conv2d(c, featdim, 3, stride, padding=1, bias=False),
                       get_norm(norm, featdim, num_gn_groups), Act(act)]
            c = featdim
        self.features = nn.ModuleList(layers)
        side = final_spatial(output_res, num_stride2_layers)
        fc_in = {"flatten": featdim * side * side, "avg": featdim,
                 "avg-max": 2 * featdim, "avg-max-min": 3 * featdim}
        if flat_op not in fc_in:
            raise ValueError(f"Invalid flat_op: {flat_op}")
        self.fc1 = nn.Linear(fc_in[flat_op], 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.fc_act = get_act(act if act != "relu" else "lrelu")
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)

    def trunk(self, coor_feat: torch.Tensor, region: Optional[torch.Tensor] = None,
              extents: Optional[torch.Tensor] = None,
              mask_attention: Optional[torch.Tensor] = None,
              drop: Optional[DropMasks] = None, progress: float = 1.0) -> torch.Tensor:
        """Everything before fc_r / fc_t: (B, 256) in fp32."""
        if coor_feat.shape[1] in (3, 5) and self.denormalize_by_extent \
                and extents is not None:
            xyz = (coor_feat[:, :3] - 0.5) * extents[:, :, None, None].to(coor_feat.dtype)
            coor_feat = torch.cat([xyz, coor_feat[:, 3:]], dim=1)
        x = coor_feat if region is None else torch.cat([coor_feat, region], dim=1)
        if self.mask_attention == "mul":
            x = x * mask_attention
        elif self.mask_attention == "concat":
            x = torch.cat([x, mask_attention], dim=1)
        elif self.mask_attention != "none":
            raise ValueError(f"Wrong mask attention type: {self.mask_attention}")
        x = self.dropblock(x.to(self.dtype), drop, progress)
        for i in range(0, len(self.features), 3):
            conv, norm, act = self.features[i:i + 3]
            x = act(norm(conv2d(conv, x, self.dtype)))
        if self.flat_op == "flatten":
            flat = torch.flatten(x, 1)                     # NCHW: channel-major
        else:
            f = torch.flatten(x, 2)                        # (B, C, HW)
            parts = {"avg": [f.mean(2)],
                     "avg-max": [f.mean(2), f.amax(2)],
                     "avg-max-min": [f.mean(2), f.amax(2), f.amin(2)]}[self.flat_op]
            flat = torch.cat(parts, dim=1)
        h = self.fc_act(linear(self.fc1, flat, self.dtype))
        return self.fc_act(linear(self.fc2, h, self.dtype)).float()

    def forward(self, coor_feat: torch.Tensor, region: Optional[torch.Tensor] = None,
                extents: Optional[torch.Tensor] = None,
                mask_attention: Optional[torch.Tensor] = None,
                drop: Optional[DropMasks] = None, progress: float = 1.0):
        """coor_feat (B, C, H, W) with xyz in channels 0:3 when C in (3, 5);
        region (B, R, H, W); extents (B, 3); mask_attention (B, 1, H, W);
        drop and progress: DropBlock's masks and ramp in training.
        Returns (rot (B, rot_dim), t (B, 3)) in fp32."""
        h = self.trunk(coor_feat, region, extents, mask_attention, drop, progress)
        return self.fc_r(h), self.fc_t(h)


class ConvPnPNetCls(ConvPnPNet):
    """ConvPnPNet with class-aware ``fc_r`` / ``fc_t`` (reference
    conv_pnp_net_cls.py): num_classes x out rows each, class-major; each ROI
    uses its label's rows (a weight gather, fp32)."""

    def __init__(self, in_channels: int, num_classes: int, **kw):
        super().__init__(in_channels, **kw)
        self.num_classes = num_classes
        self.fc_r = nn.Linear(256, num_classes * self.fc_r.out_features)
        self.fc_t = nn.Linear(256, num_classes * 3)

    def forward(self, coor_feat, region=None, extents=None, mask_attention=None,
                drop: Optional[DropMasks] = None, progress: float = 1.0,
                labels: Optional[torch.Tensor] = None):
        if labels is None:
            raise ValueError("ConvPnPNetCls requires roi labels")
        h = self.trunk(coor_feat, region, extents, mask_attention, drop, progress)
        lab = labels.long()

        def cls_fc(fc):
            d = fc.out_features // self.num_classes
            w = fc.weight.reshape(self.num_classes, d, -1)[lab]         # (B, d, 256)
            b = fc.bias.reshape(self.num_classes, d)[lab]
            return torch.einsum("bc,bdc->bd", h, w) + b

        return cls_fc(self.fc_r), cls_fc(self.fc_t)
