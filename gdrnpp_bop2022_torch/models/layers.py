"""Shared building blocks (NCHW tensors, channels_last memory).

Port of ``gdrnpp_bop2022_tpu/models/layers.py``. Parameters are fp32. A
module built with ``dtype=bf16`` runs its convolutions and linear layers in
bf16 (weights cast at the call, as flax does with ``dtype=bf16,
param_dtype=fp32``) while norms compute their statistics in fp32 and cast
back.

Padding: ``ConvModule`` pads (k - 1) // 2 on both sides, as torch does. The
ResNet and ResNeSt backbones, ``ConvFuseNet`` and the Std/Mean convs follow
flax's "SAME" instead (``same_pads``): ceil(n / stride) outputs, the total
padding split low = total // 2, high = the rest, so a stride-2 window on an
even input pads (0, 1) where torch pads (1, 1). Max pools pad with -inf,
average pools divide by the whole window (flax's ``count_include_pad``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * hsigmoid(x)


_ACTS = {
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    # "gelu" is the tanh approximation, as in the JAX package (flax's
    # nn.gelu default); "gelu_exact" is the erf form of torch's nn.GELU()
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
    "swish": F.silu,
    "mish": _mish,
    "hswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "hsigmoid": hsigmoid,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def get_act(name: str) -> Callable:
    name = name.lower()
    if name not in _ACTS:
        raise ValueError(f"Unknown activation: {name}")
    return _ACTS[name]


class Act(nn.Module):
    """An activation as a parameter-free module (keeps the reference's
    ModuleList indices: [conv, norm, act] triplets)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_act(name)

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self):
        return self.name


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with fp32 statistics, eps 1e-5 and min(groups, C) groups."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(min(num_groups, num_channels), num_channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class LayerNormChannels(nn.Module):
    """flax ``nn.LayerNorm`` over the channel axis (eps 1e-6), fp32."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        y = F.layer_norm(x.float().permute(0, 2, 3, 1), (x.shape[1],),
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


def get_norm(name: str, num_channels: int, num_gn_groups: int = 32) -> nn.Module:
    name = (name or "none").upper()
    if name == "GN":
        return GroupNorm32(num_gn_groups, num_channels)
    if name == "LN":
        return LayerNormChannels(num_channels)
    if name in ("NONE", ""):
        return nn.Identity()
    raise ValueError(f"Unknown norm: {name}")


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run ``conv`` in ``dtype`` with its fp32 parameters cast at the call."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = None if fc.bias is None else fc.bias.to(dtype)
    return F.linear(x.to(dtype), fc.weight.to(dtype), b)


class AconC(nn.Module):
    """ACON-C, (p1 - p2) x sigmoid(beta (p1 - p2) x) + p2 x with learned
    per-channel p1, p2 and beta (reference lib/torch_utils/layers/acon.py),
    in the input's dtype. The parameters are (C,), as in the JAX package (the
    reference's are (1, C, 1, 1)): the optimizer's gradient centralization
    leaves 1-D tensors alone, as the JAX package's does."""

    def __init__(self, width: int):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(width))
        self.p2 = nn.Parameter(torch.randn(width))
        self.beta = nn.Parameter(torch.ones(width))

    def forward(self, x):
        c = lambda v: v.to(x.dtype)[:, None, None]      # noqa: E731  (C, 1, 1) for NCHW
        dpx = c(self.p1 - self.p2) * x
        return dpx * torch.sigmoid(c(self.beta) * dpx) + c(self.p2) * x


class ConvModule(nn.Module):
    """conv -> norm -> act, reference names ``conv`` and ``gn`` (the norm,
    whichever it is), and ``acon`` for ``act="acon"``.

    Pads explicitly by (k - 1) // 2 and has no bias: SAME at stride 1, and
    torch's padding=1 at stride 2.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, norm: str = "GN",
                 num_gn_groups: int = 32, act: str = "gelu",
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=(kernel_size - 1) // 2, bias=use_bias)
        self.gn = get_norm(norm, out_channels, num_gn_groups)
        if act == "acon":
            self.acon = AconC(out_channels)
        else:
            self.act = get_act(act)

    def forward(self, x):
        x = self.gn(conv2d(self.conv, x, self.dtype))
        return self.acon(x) if hasattr(self, "acon") else self.act(x)


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of flax's "SAME" (``lax.padtype_to_pads``) for a
    window of ``kernel`` taps ``dilation`` apart at ``stride`` over ``size``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """``x`` (N, C, H, W) padded as flax's "SAME" pads it."""
    (t, b), (l, r) = (same_pads(n, kernel, stride, dilation) for n in x.shape[-2:])
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` padded as flax's "SAME", run in ``dtype``; a symmetric
    padding goes to the convolution itself, an asymmetric one through
    ``F.pad`` first."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, kernel_size, stride, 0, dilation,
                         groups, bias)
        self.dtype = dtype

    def forward(self, x):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        (t, b), (l, r) = (same_pads(n, k, s, d) for n in x.shape[-2:])
        x = x.to(self.dtype)
        if (t, l) == (b, r):
            pad = (t, l)
        else:
            x, pad = F.pad(x, (l, r, t, b)), 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad,
                        self.dilation, self.groups)


class MaxPoolSame(nn.Module):
    """flax ``nn.max_pool(padding="SAME")``: pads with -inf."""

    def __init__(self, kernel: int, stride: int):
        super().__init__()
        self.kernel, self.stride = kernel, stride

    def forward(self, x):
        return F.max_pool2d(pad_same(x, self.kernel, self.stride, value=-math.inf),
                            self.kernel, self.stride)


class AvgPoolSame(MaxPoolSame):
    """flax ``nn.avg_pool(padding="SAME")``: pads with 0 and divides by the
    whole window at the border too."""

    def forward(self, x):
        return F.avg_pool2d(pad_same(x, self.kernel, self.stride), self.kernel, self.stride)


def soft_argmax(x: torch.Tensor, beta: float = 1000.0, dim: int = 1,
                keepdim: bool = True) -> torch.Tensor:
    """sum_i i * softmax(beta * x)_i over ``dim``: a near-hard, differentiable
    argmax (reference lib/torch_utils/layers/layer_utils.py:97-110)."""
    smax = torch.softmax(x * beta, dim=dim)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    idx = torch.arange(x.shape[dim], dtype=x.dtype, device=x.device).reshape(shape)
    return (smax * idx).sum(dim=dim, keepdim=keepdim)


class CoordAtt(nn.Module):
    """Coordinate attention (reference lib/torch_utils/layers/
    coord_attention.py): means along each spatial axis, a shared 1x1
    bottleneck of mip = max(8, C // 32) channels, GroupNorm with
    gcd(8, mip) groups in place of the reference's BatchNorm (as the JAX
    package has it), h-swish, and sigmoid gates per (row, channel) and per
    (column, channel)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mip = max(8, channels // 32)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, mip, 1)
        self.bn1 = GroupNorm32(math.gcd(8, mip), mip)
        self.conv_h = nn.Conv2d(mip, channels, 1)
        self.conv_w = nn.Conv2d(mip, channels, 1)

    def forward(self, x):
        H = x.shape[2]
        x_h = x.mean(3, keepdim=True)                                # (B, C, H, 1)
        x_w = x.mean(2, keepdim=True).transpose(2, 3)                # (B, C, W, 1)
        y = hswish(self.bn1(conv2d(self.conv1, torch.cat([x_h, x_w], 2), self.dtype)))
        a_h = torch.sigmoid(conv2d(self.conv_h, y[:, :, :H], self.dtype))
        a_w = torch.sigmoid(conv2d(self.conv_w, y[:, :, H:].transpose(2, 3), self.dtype))
        return x * a_h * a_w


class _MappedConv(nn.Module):
    """A conv (or transposed conv) whose raw weight is the parameter and
    whose kernel is mapped at every forward (reference
    std_conv_transpose.py, mean_conv_deconv.py): "std" standardises each
    output filter (mean 0, biased variance 1, eps 1e-6 inside the rsqrt),
    "mean" centres it. Padding is flax's "SAME" (a transposed conv gives
    stride x the input)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, transpose: bool = False, mapping: str = "std",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel_size, self.stride, self.transpose = kernel_size, stride, transpose
        self.mapping, self.dtype = mapping, dtype
        shape = ((in_channels, out_channels) if transpose else (out_channels, in_channels))
        self.weight = nn.Parameter(torch.empty(*shape, kernel_size, kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def mapped_weight(self) -> torch.Tensor:
        # each output filter: dims (1, 2, 3) of a conv's (O, I, k, k),
        # (0, 2, 3) of a transposed conv's (I, O, k, k)
        dims = (0, 2, 3) if self.transpose else (1, 2, 3)
        w = self.weight - self.weight.mean(dims, keepdim=True)
        if self.mapping == "std":
            w = w * torch.rsqrt(self.weight.var(dims, unbiased=False, keepdim=True) + 1e-6)
        return w

    def forward(self, x):
        w = self.mapped_weight().to(self.dtype)
        b = self.bias.to(self.dtype)
        x = x.to(self.dtype)
        k, s = self.kernel_size, self.stride
        if not self.transpose:
            return F.conv2d(pad_same(x, k, s), w, b, s)
        # lax.conv_transpose's SAME padding of the stride-dilated input;
        # conv_transpose2d without padding pads k - 1 on each side, so the
        # difference is cropped (negative) or added
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
        hi = pad_len - lo
        y = F.conv_transpose2d(x, w, b, s)
        d_lo, d_hi = lo - (k - 1), hi - (k - 1)
        return F.pad(y, (d_lo, d_hi, d_lo, d_hi))


def StdConv(in_channels, out_channels, kernel_size=3, **kw):
    return _MappedConv(in_channels, out_channels, kernel_size, mapping="std", **kw)


def StdConvTranspose(in_channels, out_channels, kernel_size=3, **kw):
    return _MappedConv(in_channels, out_channels, kernel_size, mapping="std",
                       transpose=True, **kw)


def MeanConv(in_channels, out_channels, kernel_size=3, **kw):
    return _MappedConv(in_channels, out_channels, kernel_size, mapping="mean", **kw)


def MeanConvTranspose(in_channels, out_channels, kernel_size=3, **kw):
    return _MappedConv(in_channels, out_channels, kernel_size, mapping="mean",
                       transpose=True, **kw)


def upsample2x(x: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """2x spatial upsample of NCHW. 'bilinear' is align_corners=True (torch's
    UpsamplingBilinear2d), computed in fp32 and cast back."""
    if method == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if method != "bilinear":
        raise ValueError(f"Unknown upsample method: {method}")
    # channels_last: the NCHW CUDA kernel gives each thread one output pixel
    # and loops over all N*C planes (5.8 ms per call at batch 64 on an
    # H100 80GB HBM3 at 700 W, against 0.38 ms in channels_last)
    x32 = x.float().contiguous(memory_format=torch.channels_last)
    return F.interpolate(x32, scale_factor=2, mode="bilinear",
                         align_corners=True).to(x.dtype)


class Upsample2x(nn.Module):
    """``upsample2x`` as a parameter-free module (one ModuleList slot)."""

    def __init__(self, method: str = "bilinear"):
        super().__init__()
        self.method = method

    def forward(self, x):
        return upsample2x(x, self.method)


class DropMasks:
    """Where drop_path and DropBlock take their Bernoulli masks in training:
    drawn from ``gen`` (a ``torch.Generator`` on the activations' device),
    or taken from ``given``, a list of masks in the order the layers draw
    them (a test feeds the masks the JAX package drew)."""

    def __init__(self, gen: Optional[torch.Generator] = None,
                 given: Optional[List[torch.Tensor]] = None):
        if (gen is None) == (given is None):
            raise ValueError("DropMasks takes a generator or a list of masks")
        self.gen = gen
        self.given = None if given is None else list(given)

    def bernoulli(self, p: float, shape, device) -> torch.Tensor:
        """A bool mask of ``shape``, True with probability p (u < p, as
        jax.random.bernoulli)."""
        if self.given is None:
            return torch.rand(shape, generator=self.gen, device=device) < p
        if not self.given:
            raise ValueError("DropMasks: more draws than given masks")
        m = self.given.pop(0).to(device=device, dtype=torch.bool)
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"DropMasks: given mask {tuple(m.shape)}, layer draws {tuple(shape)}")
        return m


def need_masks(drop: Optional[DropMasks], what: str) -> DropMasks:
    if drop is None:
        raise ValueError(f"{what} in training with a rate above 0 needs a DropMasks")
    return drop


class DropBlock2D(nn.Module):
    """DropBlock with a linear ramp (reference
    lib/torch_utils/layers/dropblock.py): the identity at inference and at
    drop_prob 0. In training the rate is ``drop_prob * progress``, progress
    in [0, 1] being the trainer's share of the run done (the JAX package
    passes it instead of counting steps). Seeds drawn at
    gamma = rate / bs^2 * HW / ((H - bs + 1)(W - bs + 1)) grow into bs x bs
    blocks (a max pool, SAME); the kept activations are rescaled by the
    kept share of each sample."""

    def __init__(self, drop_prob: float = 0.0, block_size: int = 5):
        super().__init__()
        self.drop_prob = drop_prob
        self.block_size = block_size

    def forward(self, x, drop: Optional[DropMasks] = None, progress: float = 1.0):
        if not self.training or self.drop_prob == 0.0:
            return x
        drop = need_masks(drop, "DropBlock2D")
        B, _, H, W = x.shape
        bs = self.block_size
        gamma = (self.drop_prob * progress / bs ** 2) * (H * W) / max(
            (H - bs + 1) * (W - bs + 1), 1)
        seeds = drop.bernoulli(gamma, (B, 1, H, W), x.device).float()
        lo = (bs - 1) // 2
        block = F.max_pool2d(F.pad(seeds, (lo, bs - 1 - lo, lo, bs - 1 - lo)), bs, stride=1)
        keep = 1.0 - block
        denom = keep.mean(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6)
        return (x.float() * keep / denom).to(x.dtype)
