"""Shared building blocks (NCHW tensors, channels_last memory).

Port of ``gdrnpp_bop2022_tpu/models/layers.py`` as far as GDRN serving and
training need it. Parameters are fp32. A module built with ``dtype=bf16`` runs
its convolutions and linear layers in bf16 (weights cast at the call, as
flax does with ``dtype=bf16, param_dtype=fp32``) while norms compute their
statistics in fp32 and cast back.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _mish(x):
    return x * torch.tanh(F.softplus(x))


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
    "hsigmoid": lambda x: torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
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


class ConvModule(nn.Module):
    """conv -> norm -> act, reference names ``conv`` and ``gn``.

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
        self.act = get_act(act)

    def forward(self, x):
        return self.act(self.gn(conv2d(self.conv, x, self.dtype)))


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
