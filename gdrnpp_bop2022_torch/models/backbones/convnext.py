"""ConvNeXt backbone with timm parameter names.

Port of ``gdrnpp_bop2022_tpu/models/backbones/convnext.py``. Names follow
timm's ConvNeXt (``stem.0/1``, ``stages.{s}.downsample.0/1``,
``stages.{s}.blocks.{b}.{conv_dw, norm, mlp.fc1, mlp.fc2, gamma}``), so a
reference checkpoint loads with ``load_state_dict``.

Activations stay NCHW in channels_last memory: the (N, H, W, C) view that
every LayerNorm takes is then contiguous (rows, C), and all 40 LayerNorms
of convnext_base go through kernel B1 (``ops/layer_norm.py``) with no copy.
The depthwise 7x7 is one ``F.conv2d(groups=dim)``; the JAX package's MXU
lowerings of it are TPU-specific and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...ops.layer_norm import layer_norm
from ..layers import DropMasks, need_masks, conv2d, get_act, linear


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NCHW channels_last tensor, fp32 statistics,
    through kernel B1 on the card."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward_nhwc(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return layer_norm(x_nhwc, self.weight, self.bias, self.eps)

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)  # no-op on the path
        return self.forward_nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear 4x -> GELU -> Linear -> layer scale,
    plus the shortcut. The MLP runs on the (N, H, W, C) view. In training
    with drop_path > 0, each sample's branch is kept with probability
    1 - drop_path and scaled by its inverse (stochastic depth)."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path: float = 0.0, gelu_exact: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.drop_path = drop_path
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.mlp = Mlp(dim, 4 * dim)
        self.act = get_act("gelu_exact" if gelu_exact else "gelu")
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x, drop: Optional[DropMasks] = None):
        h = conv2d(self.conv_dw, x, self.dtype)
        h = h.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        h = self.norm.forward_nhwc(h)
        h = self.act(linear(self.mlp.fc1, h, self.dtype))
        h = linear(self.mlp.fc2, h, self.dtype)
        h = h * self.gamma.to(h.dtype)
        if self.training and self.drop_path > 0.0:
            keep = 1.0 - self.drop_path
            mask = need_masks(drop, "drop_path").bernoulli(keep, (h.shape[0], 1, 1, 1),
                                                            h.device)
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return x + h.permute(0, 3, 1, 2)


class Downsample(nn.Sequential):
    """LN then 2x2 stride-2 conv (timm ``downsample.0`` / ``.1``)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__(LayerNorm2d(in_dim), nn.Conv2d(in_dim, out_dim, 2, 2))
        self.dtype = dtype

    def forward(self, x):
        return conv2d(self[1], self[0](x), self.dtype)


class Stem(nn.Sequential):
    """4x4 stride-4 conv then LN (timm ``stem.0`` / ``.1``)."""

    def __init__(self, in_chans: int, dim: int, dtype: torch.dtype):
        super().__init__(nn.Conv2d(in_chans, dim, 4, 4), LayerNorm2d(dim))
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self[1](conv2d(self[0], x, self.dtype))


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, first: bool,
                 dp_rates: Sequence[float], gelu_exact: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.downsample = nn.Identity() if first else Downsample(in_dim, dim, dtype)
        self.blocks = nn.Sequential(*[
            ConvNeXtBlock(dim, drop_path=dp_rates[i], gelu_exact=gelu_exact,
                          dtype=dtype) for i in range(depth)])

    def forward(self, x, drop: Optional[DropMasks] = None):
        x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x, drop)
        return x


class ConvNeXt(nn.Module):
    """ConvNeXt feature extractor on NCHW input.

    Returns the features of ``out_indices`` (one tensor when there is one
    index); out_indices=(3,) gives the stride-32 map (B, dims[3], H/32, W/32).
    drop_path rates rise linearly over the blocks from 0 to drop_path_rate
    (GDRN builds it at 0, as the JAX package does); ``drop`` gives the
    masks in training.
    """

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 drop_path_rate: float = 0.0,
                 out_indices: Tuple[int, ...] = (3,),
                 gelu_exact: bool = False, in_chans: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_indices = tuple(out_indices)
        dp = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stem = Stem(in_chans, dims[0], dtype)
        stages, cur = [], 0
        for s in range(4):
            stages.append(ConvNeXtStage(dims[max(s - 1, 0)], dims[s], depths[s],
                                        s == 0, dp[cur:cur + depths[s]],
                                        gelu_exact, dtype))
            cur += depths[s]
        self.stages = nn.ModuleList(stages)

    def forward(self, x, drop: Optional[DropMasks] = None):
        x = self.stem(x)
        feats = []
        for s, stage in enumerate(self.stages):
            x = stage(x, drop)
            if s in self.out_indices:
                feats.append(x)
        return feats if len(feats) > 1 else feats[0]


def convnext_tiny(**kw):
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kw)


def convnext_small(**kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kw)


def convnext_base(**kw):
    return ConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024), **kw)
