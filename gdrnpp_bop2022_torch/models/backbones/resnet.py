"""ResNet backbones with GroupNorm and flax "SAME" padding.

Port of ``gdrnpp_bop2022_tpu/models/backbones/resnet.py`` (the reference's
torchvision/mmcv ResNets, net_factory.py:39-75, and the PVNet-heritage
dilated stride-8 nets). Names follow timm's ResNet (``conv1``, ``bn1``,
``layer{1-4}.{j}.conv{k}`` / ``bn{k}``, ``downsample.{0,1}``) with a
GroupNorm (32 groups, eps 1e-5, fp32 statistics) in each norm slot.

No released torchvision or timm checkpoint computes this function: their
BatchNorms are GroupNorms here, and every conv and pool pads as flax's
"SAME" does (the 7x7 stride-2 stem pads (2, 3) on an even input where
torchvision pads (3, 3); the stride-2 3x3 convs and the max pool pad
(0, 1)), which shifts each feature map by a pixel. Weights come from the
JAX package through ``utils/weights.py`` or from a seed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2dSame, DropMasks, GroupNorm32, MaxPoolSame


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_c: int, features: int, stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = Conv2dSame(in_c, features, 3, stride, dilation, dtype=dtype)
        self.bn1 = GroupNorm32(32, features)
        self.conv2 = Conv2dSame(features, features, 3, 1, dilation, dtype=dtype)
        self.bn2 = GroupNorm32(32, features)
        self.downsample = (nn.Sequential(Conv2dSame(in_c, features, 1, stride, dtype=dtype),
                                         GroupNorm32(32, features))
                           if stride != 1 or in_c != features else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + h)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_c: int, features: int, stride: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dilation != 1:
            raise ValueError("dilated output_stride is implemented for the basic block")
        out_c = 4 * features
        self.conv1 = Conv2dSame(in_c, features, 1, dtype=dtype)
        self.bn1 = GroupNorm32(32, features)
        self.conv2 = Conv2dSame(features, features, 3, stride, dtype=dtype)
        self.bn2 = GroupNorm32(32, features)
        self.conv3 = Conv2dSame(features, out_c, 1, dtype=dtype)
        self.bn3 = GroupNorm32(32, out_c)
        self.downsample = (nn.Sequential(Conv2dSame(in_c, out_c, 1, stride, dtype=dtype),
                                         GroupNorm32(32, out_c))
                           if stride != 1 or in_c != out_c else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + h)


class ResNet(nn.Module):
    """Stem (7x7 stride 2, GN, ReLU, 3x3 max pool stride 2), then four
    stages of 64 * 2^i features (times 4 for the bottleneck). Returns the
    features of ``out_indices`` (one tensor for one index). With
    ``output_stride`` 8 or 16 a stage whose stride would pass it is dilated
    instead, the dilation doubling each time, from the stage's first block
    on (the JAX package's rule)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck",
                 out_indices: Tuple[int, ...] = (3,), output_stride: int = 32,
                 in_chans: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if output_stride not in (8, 16, 32):
            raise ValueError(f"output_stride={output_stride}: 8, 16 or 32")
        block_cls = {"basic": BasicBlock, "bottleneck": Bottleneck}[block]
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2dSame(in_chans, 64, 7, 2, dtype=dtype)
        self.bn1 = GroupNorm32(32, 64)
        self.maxpool = MaxPoolSame(3, 2)
        c, stride, dilation = 64, 4, 1
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                s = 2 if (j == 0 and i > 0) else 1
                if s > 1 and stride >= output_stride:
                    dilation, s = 2 * dilation, 1      # replace the stride by dilation
                elif s > 1:
                    stride *= 2
                blocks.append(block_cls(c, 64 * 2 ** i, s, dilation, dtype=dtype))
                c = 64 * 2 ** i * block_cls.expansion
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


def resnet34(**kw):
    return ResNet((3, 4, 6, 3), "basic", **kw)


def resnet50(**kw):
    return ResNet((3, 4, 6, 3), "bottleneck", **kw)


def resnet101(**kw):
    return ResNet((3, 4, 23, 3), "bottleneck", **kw)


def resnet18_8s(**kw):
    """The dilated resnet18 at output stride 8 (reference net_factory.py:13-18)."""
    return ResNet((2, 2, 2, 2), "basic", output_stride=8, **kw)


def resnet34_8s(**kw):
    return ResNet((3, 4, 6, 3), "basic", output_stride=8, **kw)
