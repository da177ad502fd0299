"""PointNet-style PnP head and the RGB-D conv fusion.

Port of ``gdrnpp_bop2022_tpu/models/heads/point_pnp_net.py``:

  * ``SimplePointPnPNet`` (reference point_pnp_net.py:208): the dense
    coordinate map as a set of H*W points, shared per-point layers
    ``conv1``-``conv3`` (128, 128, then 1024 for the global max pool or 128
    for the top-k "softpool"), leaky ReLU 0.1, then ``fc1`` (512), ``fc2``
    (256) and ``fc_pose`` (rot_dim + 3, fp32). The per-point layers are
    ``nn.Linear`` (the JAX package's Dense over points).
  * ``ConvFuseNet`` (reference fusenets/conv_fuse_net.py): the RGB and
    depth features concatenated, then twice a 3x3 conv (no bias) ->
    GroupNorm(min(32, C) groups, eps 1e-6 as flax's ``nn.GroupNorm``
    defaults, fp32) -> ReLU, to the RGB feature's width.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import DropMasks, conv2d, linear


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.1)


class SimplePointPnPNet(nn.Module):
    def __init__(self, in_channels: int, rot_dim: int = 6, use_softpool: bool = False,
                 softpool_topk: int = 32, mask_attention: str = "none",
                 denormalize_by_extent: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.rot_dim = rot_dim
        self.use_softpool = use_softpool
        self.softpool_topk = softpool_topk
        self.mask_attention = mask_attention
        self.denormalize_by_extent = denormalize_by_extent
        self.conv1 = nn.Linear(in_channels, 128)
        self.conv2 = nn.Linear(128, 128)
        self.conv3 = nn.Linear(128, 128 if use_softpool else 1024)
        self.fc1 = nn.Linear(128 * softpool_topk if use_softpool else 1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc_pose = nn.Linear(256, rot_dim + 3)

    def forward(self, coor_feat: torch.Tensor, region: Optional[torch.Tensor] = None,
                extents: Optional[torch.Tensor] = None,
                mask_attention: Optional[torch.Tensor] = None,
                drop: Optional[DropMasks] = None, progress: float = 1.0):
        """coor_feat (B, C, H, W), as ConvPnPNet takes it -> (rot (B,
        rot_dim), t (B, 3)) in fp32. No dropout: drop and progress are
        unused."""
        if coor_feat.shape[1] in (3, 5) and self.denormalize_by_extent \
                and extents is not None:
            xyz = (coor_feat[:, :3] - 0.5) * extents[:, :, None, None].to(coor_feat.dtype)
            coor_feat = torch.cat([xyz, coor_feat[:, 3:]], dim=1)
        x = coor_feat if region is None else torch.cat([coor_feat, region], dim=1)
        if self.mask_attention == "mul":
            x = x * mask_attention
        elif self.mask_attention == "concat":
            x = torch.cat([x, mask_attention], dim=1)
        pts = x.flatten(2).transpose(1, 2)                              # (B, HW, C)
        h = _lrelu(linear(self.conv1, pts, self.dtype))
        h = _lrelu(linear(self.conv2, h, self.dtype))
        h = _lrelu(linear(self.conv3, h, self.dtype))
        if self.use_softpool:     # the top k of each channel over the points
            g = torch.topk(h.transpose(1, 2), self.softpool_topk, dim=-1).values.flatten(1)
        else:
            g = h.amax(1)
        g = _lrelu(linear(self.fc1, g, self.dtype))
        g = _lrelu(linear(self.fc2, g, self.dtype))
        pose = self.fc_pose(g.float())
        return pose[:, :self.rot_dim], pose[:, self.rot_dim:]


class ConvFuseNet(nn.Module):
    def __init__(self, rgb_channels: int, depth_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        c = rgb_channels + depth_channels
        for i in range(2):
            self.add_module(f"conv{i}", nn.Conv2d(c, rgb_channels, 3, padding=1, bias=False))
            self.add_module(f"gn{i}", nn.GroupNorm(min(32, rgb_channels), rgb_channels,
                                                   eps=1e-6))
            c = rgb_channels

    def forward(self, rgb_feat: torch.Tensor, depth_feat: torch.Tensor) -> torch.Tensor:
        x = torch.cat([rgb_feat, depth_feat], dim=1)
        for i in range(2):
            x = conv2d(getattr(self, f"conv{i}"), x, self.dtype)
            gn = getattr(self, f"gn{i}")
            x = F.relu(F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                                    gn.eps).to(x.dtype))
        return x
