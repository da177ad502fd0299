"""CSPDarknet backbone of YOLOX (NCHW modules).

Port of ``gdrnpp_bop2022_tpu/models/yolox/darknet.py`` under the reference's
torch module names (det/yolox/models/network_blocks.py and darknet.py:
``BaseConv`` = ``conv`` + ``bn``, ``DWConv`` = ``dconv`` + ``pconv``,
``Bottleneck``, ``CSPLayer`` = ``conv1..3`` + ``m``, ``SPPBottleneck``,
``Focus`` = ``conv``, ``CSPDarknet`` = ``stem`` + ``dark2..5``), so a released
``.pth`` loads with ``load_state_dict``.

The norm module is named ``bn`` whichever norm it is:
  * ``GN`` (the JAX package's default): GroupNorm with flax's eps 1e-6 and,
    as group count, the largest divisor of C that is <= 32 (yolox-x widths
    such as 80 and 160 are not multiples of 32);
  * ``BN``: BatchNorm with eps 1e-3 and momentum 0.03 (the reference's
    BaseConv, the layout of its released BOP'22 weights) as flax's
    ``nn.BatchNorm(momentum=0.97, epsilon=1e-3)`` computes it: in eval mode
    with the running statistics, in training mode with the batch's
    statistics and the biased variance, for the output and for the running
    update alike (``BatchNormFp32``).
Convolutions run in ``dtype`` with fp32 parameters cast at the call; norms
compute in fp32 and cast back. Stride-2 convolutions pad (p, p) as torch
does. With ``depthwise=True`` the stride-2 convolutions stay dense, as in the
JAX package (the reference makes them DWConv).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import conv2d


def gn_groups(c: int) -> int:
    """The largest divisor of c that is <= 32."""
    return next(g for g in range(min(32, c), 0, -1) if c % g == 0)


class GroupNormFp32(nn.GroupNorm):
    def __init__(self, num_channels: int):
        super().__init__(gn_groups(num_channels), num_channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNormFp32(nn.BatchNorm2d):
    """BatchNorm2d's buffers and parameters (a reference ``.pth`` loads),
    computed as flax's BatchNorm does (``gdrnpp_bop2022_tpu/models/yolox/
    darknet.py:50``). In training mode the batch's mean and its biased
    variance E[x^2] - E[x]^2 (clipped at 0), in fp32, normalise the batch and
    update ``running_* = 0.97 running_* + 0.03 batch`` (torch's own
    BatchNorm2d would update the variance with the unbiased n / (n - 1)
    times it)."""

    def __init__(self, num_channels: int):
        super().__init__(num_channels, eps=1e-3, momentum=0.03)

    def forward(self, x):
        x32 = x.float()
        if not self.training:
            return F.batch_norm(x32, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(x.dtype)
        mean = x32.mean((0, 2, 3))
        var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


_NORMS = {"GN": GroupNormFp32, "BN": BatchNormFp32}


class BaseConv(nn.Module):
    """conv (no bias, (k - 1) // 2 padding) -> norm -> SiLU."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 norm: str = "GN", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"norm={norm!r}: GN or BN")
        self.dtype = dtype
        self.act = act
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              (ksize - 1) // 2, groups=groups, bias=False)
        self.bn = _NORMS[norm](out_channels)

    def forward(self, x):
        x = self.bn(conv2d(self.conv, x, self.dtype))
        return F.silu(x) if self.act else x


class DWConv(nn.Module):
    """Depthwise conv -> pointwise conv, each a BaseConv."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, norm: str = "GN", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, norm=norm, dtype=dtype)
        self.pconv = BaseConv(in_channels, out_channels, 1, norm=norm, dtype=dtype)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def _conv_cls(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False, norm: str = "GN",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, norm=norm, dtype=dtype)
        self.conv2 = _conv_cls(depthwise)(hidden, out_channels, 3, norm=norm, dtype=dtype)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, norm: str = "GN",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, norm=norm, dtype=dtype)
        self.conv2 = BaseConv(in_channels, hidden, 1, norm=norm, dtype=dtype)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, norm=norm, dtype=dtype)
        self.m = nn.Sequential(*[Bottleneck(hidden, hidden, shortcut, 1.0, depthwise,
                                            norm=norm, dtype=dtype) for _ in range(n)])

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], dim=1))


class SPPBottleneck(nn.Module):
    """conv1 -> [x, maxpool_k(x) for k] -> conv2; the pools pad with -inf
    (flax's SAME max pool)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), norm: str = "GN",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, norm=norm, dtype=dtype)
        self.m = nn.ModuleList([nn.MaxPool2d(k, 1, k // 2) for k in kernel_sizes])
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels, 1,
                              norm=norm, dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], dim=1))


def focus_rearrange(x: torch.Tensor) -> torch.Tensor:
    """Pixel-unshuffle 2x of NCHW in the reference Focus's channel order:
    [top-left, bottom-left, top-right, bottom-right] blocks of C channels
    (the JAX package's ``focus_rearrange`` flattens (dy, dx, c) instead; the
    weight bridge permutes the stem's input channels between the two)."""
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                      x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)


class Focus(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 norm: str = "GN", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, norm=norm, dtype=dtype)

    def forward(self, x):
        return self.conv(focus_rearrange(x))


class CSPDarknet(nn.Module):
    """Returns the strides 8, 16 and 32 features (dark3, dark4, dark5)."""

    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 depthwise: bool = False, norm: str = "GN",
                 dtype: torch.dtype = torch.bfloat16, in_chans: int = 3):
        super().__init__()
        c = int(wid_mul * 64)
        d = max(round(dep_mul * 3), 1)
        kw = dict(norm=norm, dtype=dtype)
        self.stem = Focus(in_chans, c, 3, **kw)
        self.dark2 = nn.Sequential(BaseConv(c, 2 * c, 3, 2, **kw),
                                   CSPLayer(2 * c, 2 * c, d, depthwise=depthwise, **kw))
        self.dark3 = nn.Sequential(BaseConv(2 * c, 4 * c, 3, 2, **kw),
                                   CSPLayer(4 * c, 4 * c, 3 * d, depthwise=depthwise, **kw))
        self.dark4 = nn.Sequential(BaseConv(4 * c, 8 * c, 3, 2, **kw),
                                   CSPLayer(8 * c, 8 * c, 3 * d, depthwise=depthwise, **kw))
        self.dark5 = nn.Sequential(BaseConv(8 * c, 16 * c, 3, 2, **kw),
                                   SPPBottleneck(16 * c, 16 * c, **kw),
                                   CSPLayer(16 * c, 16 * c, d, shortcut=False,
                                            depthwise=depthwise, **kw))
        self.out_channels = (4 * c, 8 * c, 16 * c)

    def forward(self, x):
        x = self.dark2(self.stem(x))
        d3 = self.dark3(x)
        d4 = self.dark4(d3)
        return d3, d4, self.dark5(d4)
