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

``int8_mlp`` serves the two pointwise MLPs as dynamic int8 matmuls
(``dense_int8``) when the block runs deterministically (eval mode); a
training step keeps the bf16 MLPs on the same parameters. ``remat``
recomputes each block's internals in the backward pass
(``torch.utils.checkpoint``, as ``nn.remat(ConvNeXtBlock)``); the stem and
the downsample layers stay outside, and each block's drop-path mask is
drawn before the block and handed to it, so the recompute is exact.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

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


def int8_codes(x2: torch.Tensor, weight: torch.Tensor):
    """The JAX ``_dense_int8``'s quantization of x2 (M, Cin) and weight
    (Cout, Cin): per output channel w_s = max(max |w| over Cin, 1e-8) / 127;
    one activation scale x_s = max(max |x|, 1e-8) / 127 over the whole
    tensor (so a row's output depends on the batch it is served in, as in
    the JAX package); codes round(v / scale), half to even, by division.
    Returns (xq (M, Cin) int8, x_s (), wq (Cout, Cin) int8, w_s (Cout,))."""
    w32 = weight.float()
    w_s = w32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    wq = torch.round(w32 / w_s[:, None]).to(torch.int8)
    x32 = x2.float()
    x_s = x32.abs().amax().clamp_min(1e-8) / 127.0
    return torch.round(x32 / x_s).to(torch.int8), x_s, wq, w_s


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 @ wq (N, K)^T int8 -> (M, N) int32 through
    ``torch._int_mm``. On the card it needs M > 16 and K, N multiples of 8;
    another shape raises."""
    (m, k), n = xq.shape, wq.shape[0]
    if xq.is_cuda and not (m > 16 and k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"int8 matmul on the card: torch._int_mm needs more than 16 rows "
                         f"and K, N multiples of 8; got ({m}, {k}) x ({k}, {n})")
    return torch._int_mm(xq, wq.t())


def dense_int8(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The JAX ``_dense_int8``, for serving: x (..., Cin) @ weight (Cout,
    Cin)^T + bias with the codes of ``int8_codes``, their int32 product
    (``int8_matmul``) and out = acc x_s w_s + b in fp32, cast to x's dtype."""
    cin, cout = weight.shape[1], weight.shape[0]
    xq, x_s, wq, w_s = int8_codes(x.reshape(-1, cin), weight)
    out = int8_matmul(xq, wq).float() * (x_s * w_s) + bias.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], cout)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear 4x -> GELU -> Linear -> layer scale,
    plus the shortcut. The MLP runs on the (N, H, W, C) view, through
    ``dense_int8`` in eval mode with ``int8_mlp``. In training with
    drop_path > 0, each sample's branch is kept with probability
    1 - drop_path and scaled by its inverse (stochastic depth); ``body``
    takes that mask (``draw_mask``) as an input."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 drop_path: float = 0.0, gelu_exact: bool = False,
                 int8_mlp: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.drop_path = drop_path
        self.int8_mlp = int8_mlp
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.mlp = Mlp(dim, 4 * dim)
        self.act = get_act("gelu_exact" if gelu_exact else "gelu")
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def draw_mask(self, x, drop: Optional[DropMasks]) -> Optional[torch.Tensor]:
        """The block's drop-path mask (N, 1, 1, 1) in training, else None."""
        if not (self.training and self.drop_path > 0.0):
            return None
        return need_masks(drop, "drop_path").bernoulli(1.0 - self.drop_path,
                                                        (x.shape[0], 1, 1, 1), x.device)

    def body(self, x, mask: Optional[torch.Tensor] = None):
        h = conv2d(self.conv_dw, x, self.dtype)
        h = h.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        h = self.norm.forward_nhwc(h)
        if self.int8_mlp and not self.training:
            h = self.act(dense_int8(h.to(self.dtype), self.mlp.fc1.weight, self.mlp.fc1.bias))
            h = dense_int8(h, self.mlp.fc2.weight, self.mlp.fc2.bias)
        else:
            h = self.act(linear(self.mlp.fc1, h, self.dtype))
            h = linear(self.mlp.fc2, h, self.dtype)
        h = h * self.gamma.to(h.dtype)
        if mask is not None:
            keep = 1.0 - self.drop_path
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return x + h.permute(0, 3, 1, 2)

    def forward(self, x, drop: Optional[DropMasks] = None):
        return self.body(x, self.draw_mask(x, drop))


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
                 dp_rates: Sequence[float], gelu_exact: bool, int8_mlp: bool,
                 remat: bool, dtype: torch.dtype):
        super().__init__()
        self.remat = remat
        self.downsample = nn.Identity() if first else Downsample(in_dim, dim, dtype)
        self.blocks = nn.Sequential(*[
            ConvNeXtBlock(dim, drop_path=dp_rates[i], gelu_exact=gelu_exact,
                          int8_mlp=int8_mlp, dtype=dtype) for i in range(depth)])

    def forward(self, x, drop: Optional[DropMasks] = None):
        x = self.downsample(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for blk in self.blocks:
            mask = blk.draw_mask(x, drop)
            # the body draws nothing (its mask is an input): no RNG state to keep
            x = (checkpoint(blk.body, x, mask, use_reentrant=False, preserve_rng_state=False)
                 if remat else blk.body(x, mask))
        return x


class ConvNeXt(nn.Module):
    """ConvNeXt feature extractor on NCHW input.

    Returns the features of ``out_indices`` (one tensor when there is one
    index); out_indices=(3,) gives the stride-32 map (B, dims[3], H/32, W/32).
    drop_path rates rise linearly over the blocks from 0 to drop_path_rate
    (GDRN builds it at 0, as the JAX package does); ``drop`` gives the
    masks in training. ``int8_mlp``: int8 MLPs in eval mode; ``remat``:
    each block recomputed in the backward pass.
    """

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 drop_path_rate: float = 0.0,
                 out_indices: Tuple[int, ...] = (3,),
                 gelu_exact: bool = False, in_chans: int = 3,
                 int8_mlp: bool = False, remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_indices = tuple(out_indices)
        dp = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.stem = Stem(in_chans, dims[0], dtype)
        stages, cur = [], 0
        for s in range(4):
            stages.append(ConvNeXtStage(dims[max(s - 1, 0)], dims[s], depths[s],
                                        s == 0, dp[cur:cur + depths[s]],
                                        gelu_exact, int8_mlp, remat, dtype))
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
