"""ResNeSt backbones (split-attention ResNets) with GroupNorm and flax
"SAME" padding.

Port of ``gdrnpp_bop2022_tpu/models/backbones/resnest.py`` (the
reference's mmcv "mm/resnest*" entries, net_factory.py:39-75): the deep
3-conv stem, radix-2 split attention, the average-pool downsample after
the split attention (avd) and the ResNeSt-D residual (a 2x2 average pool,
then a 1x1 conv). Names follow timm's ResNeSt where a module has a
counterpart (``conv1.{0,3,6}`` and their norms ``conv1.{1,4}``, ``bn1``;
``layer{1-4}.{j}.conv1`` / ``bn1``, ``conv2.{conv, bn0, fc1, bn1, fc2}``,
``conv3`` / ``bn3``, ``downsample.{1,2}`` behind the pool ``downsample.0``),
with a GroupNorm in each norm slot.

The split attention's ``bn1`` is a GroupNorm of 32 groups over the pooled
(B, inter) vector, inter = max(f * radix / 4, 32). In stage 0 (f = 64)
each group holds one value, so that norm returns its bias whatever the
input: stage 0's attention does not depend on the input. The port keeps
this, as the JAX package computes it (mmcv has a BatchNorm there).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import AvgPoolSame, Conv2dSame, DropMasks, GroupNorm32, MaxPoolSame, linear


class SplitAttention(nn.Module):
    """A grouped 3x3 conv (groups = radix = 2) to 2 f channels, GN, ReLU;
    the radix splits are a channel reshape (B, 2, f, H, W); their sum's
    spatial mean goes through fc1 -> GN -> ReLU -> fc2 (linear layers, as
    the JAX package's Dense; timm has 1x1 convs; inter = max(f / 2, 32)) to
    2 f logits, and a softmax over the radix (rSoftMax) weighs the splits."""

    radix = 2

    def __init__(self, in_c: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        r = self.radix
        self.features, self.dtype = features, dtype
        inter = max(features * r // 4, 32)
        self.conv = Conv2dSame(in_c, features * r, 3, stride, groups=r, dtype=dtype)
        self.bn0 = GroupNorm32(32, features * r)
        self.fc1 = nn.Linear(features, inter)
        self.bn1 = GroupNorm32(32, inter)
        self.fc2 = nn.Linear(inter, features * r)

    def forward(self, x):
        r, f = self.radix, self.features
        h = F.relu(self.bn0(self.conv(x)))
        B, _, H, W = h.shape
        splits = h.reshape(B, r, f, H, W)
        gap = splits.sum(1).mean((2, 3))                                 # (B, f)
        a = F.relu(self.bn1(linear(self.fc1, gap, self.dtype)))          # GN over (B, inter)
        att = torch.softmax(linear(self.fc2, a, self.dtype).reshape(B, r, f), dim=1)
        return (splits * att[..., None, None].to(splits.dtype)).sum(1)


class ResNeStBottleneck(nn.Module):
    """1x1 -> split attention -> (stride > 1: 3x3 average pool, "avd") ->
    1x1 (4 f), plus the residual (ResNeSt-D: a 2x2 average pool, then 1x1)."""

    def __init__(self, in_c: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out_c = 4 * features
        self.conv1 = Conv2dSame(in_c, features, 1, dtype=dtype)
        self.bn1 = GroupNorm32(32, features)
        self.conv2 = SplitAttention(features, features, dtype=dtype)
        self.avd_last = AvgPoolSame(3, stride) if stride > 1 else None
        self.conv3 = Conv2dSame(features, out_c, 1, dtype=dtype)
        self.bn3 = GroupNorm32(32, out_c)
        self.downsample = (nn.Sequential(AvgPoolSame(2, stride) if stride > 1 else nn.Identity(),
                                         Conv2dSame(in_c, out_c, 1, dtype=dtype),
                                         GroupNorm32(32, out_c))
                           if stride != 1 or in_c != out_c else None)

    def forward(self, x):
        h = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd_last is not None:
            h = self.avd_last(h)
        h = self.bn3(self.conv3(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + h)


class ResNeSt(nn.Module):
    """Deep stem (3x3 convs of stem_width stride 2, stem_width, 2 stem_width,
    each GN + ReLU), a 3x3 max pool stride 2, then four stages of
    ResNeSt bottlenecks (64 * 2^i features, out 4x). Returns the features of
    ``out_indices`` (one tensor for one index)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), stem_width: int = 32,
                 out_indices: Tuple[int, ...] = (3,), in_chans: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_indices = tuple(out_indices)
        sw = stem_width
        self.conv1 = nn.Sequential(
            Conv2dSame(in_chans, sw, 3, 2, dtype=dtype), GroupNorm32(32, sw), nn.ReLU(),
            Conv2dSame(sw, sw, 3, 1, dtype=dtype), GroupNorm32(32, sw), nn.ReLU(),
            Conv2dSame(sw, 2 * sw, 3, 1, dtype=dtype))
        self.bn1 = GroupNorm32(32, 2 * sw)
        self.maxpool = MaxPoolSame(3, 2)
        c = 2 * sw
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                blocks.append(ResNeStBottleneck(c, 64 * 2 ** i, 2 if (j == 0 and i > 0) else 1,
                                                dtype=dtype))
                c = 4 * 64 * 2 ** i
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x, drop: Optional[DropMasks] = None):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        feats = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                feats.append(x)
        return feats if len(feats) > 1 else feats[0]


def resnest50(**kw):
    return ResNeSt((3, 4, 6, 3), **kw)


def resnest101(**kw):
    return ResNeSt((3, 4, 23, 3), stem_width=64, **kw)
