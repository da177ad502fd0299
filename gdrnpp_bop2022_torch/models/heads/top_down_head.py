"""GDRN geometric heads: top-down (double or single mask), conv-only and FPN.

Port of ``gdrnpp_bop2022_tpu/models/heads/top_down_head.py``. The four heads
share the class-aware out conv ``out_layer`` and differ in the trunk before
it (reference names):

  * ``TopDownDoubleMaskXyzRegionHead`` (visible + full mask) and
    ``TopDownMaskXyzRegionHead`` (visible mask only, ``full_mask`` None):
    the anonymous ``features`` ModuleList, per up-block [ConvTranspose2d,
    norm, act] for "deconv" or [Upsample] for "bilinear"/"nearest", then
    ``num_conv_per_block`` ConvModules;
  * ``ConvMaskXyzRegionHead``: ``features`` = two ConvModules at the input
    stride (single mask);
  * ``FPNMaskXyzRegionHead``: the four stage features (strides 4-32);
    ``scale_heads.{i}`` holds level i's ConvModule (+ 2x bilinear upsample)
    chain down to stride 4, the levels are summed (single mask).

``out_layer`` keeps the reference's group-major channel order so released
state dicts load as they are. The JAX package orders channels class-major;
``geo_out_channel_perm`` maps one onto the other. With per-ROI labels the
class-aware out conv gathers each ROI's slice of the out-conv weights and
computes only those channels, in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils.channel_perm import geo_out_channel_perm
from ..layers import Act, ConvModule, Upsample2x, get_norm


class _Deconv(nn.ConvTranspose2d):
    """k3 s2 p1 op1 transposed conv (an exact 2x upsample) in ``dtype``."""

    def __init__(self, in_c: int, out_c: int, kernel_size: int, dtype):
        super().__init__(in_c, out_c, kernel_size, stride=2,
                         padding=(kernel_size - 1) // 2, output_padding=1,
                         bias=False)
        self.dtype = dtype

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  None, self.stride, self.padding,
                                  self.output_padding)


class _MaskXyzRegionHead(nn.Module):
    """The out conv shared by every geo head, and the split of its groups
    into (vis_mask, full_mask, coor_x, coor_y, coor_z, region), NCHW.
    Subclasses build their trunk, then call ``_init_out``."""

    double_mask = True

    def _init_out(self, in_dim: int, out_kernel_size: int, mask_num_classes: int,
                  xyz_num_classes: int, region_num_classes: int, mask_out_dim: int,
                  xyz_out_dim: int, region_out_dim: int):
        self.layout = [("mask", mask_out_dim, mask_num_classes),
                       ("xyz", xyz_out_dim, xyz_num_classes),
                       ("region", region_out_dim, region_num_classes)]
        total = sum(d * n for _, d, n in self.layout)
        self.out_layer = nn.Conv2d(in_dim, total, out_kernel_size,
                                   padding=(out_kernel_size - 1) // 2)
        # jax_channel[i] = ref_channel[perm[i]]
        perm = geo_out_channel_perm(mask_out_dim, xyz_out_dim, region_out_dim,
                                    mask_num_classes, xyz_num_classes,
                                    region_num_classes, double_mask=self.double_mask)
        self.register_buffer("out_perm", torch.as_tensor(perm), persistent=False)

    def _trunk(self, x):
        for layer in self.features:
            x = layer(x)
        return x

    def _out_layer(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> dict:
        """fp32 out conv -> per-group maps (B, D, H, W) in the JAX package's
        class-major channel order, gathered by label where class-aware."""
        xf = x.float()
        k = self.out_layer.kernel_size[0]
        class_aware = any(n > 1 for _, _, n in self.layout)
        if class_aware and labels is None:
            raise ValueError("class-aware head requires per-ROI labels")
        w = self.out_layer.weight           # (total, C, k, k), reference order
        b = self.out_layer.bias
        outs = {}
        off = 0
        if k == 1:
            # weight gather: only each ROI's own class channels are computed
            w2 = w[:, :, 0, 0]
            for name, d, n in self.layout:
                ar = torch.arange(d, device=x.device)
                if n > 1:
                    idx = self.out_perm[off + labels.long()[:, None] * d + ar]
                    outs[name] = (torch.einsum("bchw,bdc->bdhw", xf, w2[idx])
                                  + b[idx][:, :, None, None])
                else:
                    idx = self.out_perm[off + ar]
                    outs[name] = (torch.einsum("bchw,dc->bdhw", xf, w2[idx])
                                  + b[idx][None, :, None, None])
                off += d * n
            return outs
        out = F.conv2d(xf, w[self.out_perm], b[self.out_perm],
                       padding=self.out_layer.padding)
        for name, d, n in self.layout:
            g = out[:, off:off + d * n]
            if n > 1:
                B, _, H, W = g.shape
                g = g.reshape(B, n, d, H, W)[torch.arange(B, device=x.device),
                                              labels.long()]
            outs[name] = g
            off += d * n
        return outs

    def forward(self, x, labels: Optional[torch.Tensor] = None) -> dict:
        outs = self._out_layer(self._trunk(x), labels)
        mask, xyz = outs["mask"], outs["xyz"]
        md = mask.shape[1]
        B, xc, H, W = xyz.shape
        xyz = xyz.reshape(B, 3, xc // 3, H, W)
        return {
            "vis_mask": mask[:, :md // 2] if self.double_mask else mask,
            "full_mask": mask[:, md // 2:] if self.double_mask else None,
            "coor_x": xyz[:, 0],
            "coor_y": xyz[:, 1],
            "coor_z": xyz[:, 2],
            "region": outs["region"],
        }


class TopDownDoubleMaskXyzRegionHead(_MaskXyzRegionHead):
    """Stride 32 -> 4 top-down decoder; visible and full masks."""

    def __init__(self, in_dim: int,
                 up_types: Sequence[str] = ("deconv", "bilinear", "bilinear"),
                 deconv_kernel_size: int = 3, num_conv_per_block: int = 2,
                 feat_dim: int = 256, feat_kernel_size: int = 3,
                 norm: str = "GN", num_gn_groups: int = 32, act: str = "gelu",
                 out_kernel_size: int = 1, mask_num_classes: int = 1,
                 xyz_num_classes: int = 1, region_num_classes: int = 1,
                 mask_out_dim: int = 2, xyz_out_dim: int = 3,
                 region_out_dim: int = 65, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        layers = []
        c = in_dim
        for up in up_types:
            if up == "deconv":
                layers += [_Deconv(c, feat_dim, deconv_kernel_size, dtype),
                           get_norm(norm, feat_dim, num_gn_groups), Act(act)]
            else:
                layers.append(Upsample2x(up))
            c = feat_dim if up == "deconv" else c
            for _ in range(num_conv_per_block):
                layers.append(ConvModule(c, feat_dim, feat_kernel_size,
                                         norm=norm, num_gn_groups=num_gn_groups,
                                         act=act, dtype=dtype))
                c = feat_dim
        self.features = nn.ModuleList(layers)
        self._init_out(c, out_kernel_size, mask_num_classes, xyz_num_classes,
                       region_num_classes, mask_out_dim, xyz_out_dim, region_out_dim)


class TopDownMaskXyzRegionHead(TopDownDoubleMaskXyzRegionHead):
    """The same decoder with the visible mask only (reference
    top_down_mask_xyz_region_head.py); ``full_mask`` is None."""

    double_mask = False


class ConvMaskXyzRegionHead(_MaskXyzRegionHead):
    """Conv-only head (reference conv_mask_xyz_region_head.py): two
    ConvModules at the input stride, no upsampling; single mask."""

    double_mask = False

    def __init__(self, in_dim: int, feat_dim: int = 256, feat_kernel_size: int = 3,
                 norm: str = "GN", num_gn_groups: int = 32, act: str = "gelu",
                 out_kernel_size: int = 1, mask_num_classes: int = 1,
                 xyz_num_classes: int = 1, region_num_classes: int = 1,
                 mask_out_dim: int = 1, xyz_out_dim: int = 3, region_out_dim: int = 65,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features = nn.ModuleList([
            ConvModule(in_dim if i == 0 else feat_dim, feat_dim, feat_kernel_size, norm=norm,
                       num_gn_groups=num_gn_groups, act=act, dtype=dtype)
            for i in range(2)])
        self._init_out(feat_dim, out_kernel_size, mask_num_classes, xyz_num_classes,
                       region_num_classes, mask_out_dim, xyz_out_dim, region_out_dim)


class FPNMaskXyzRegionHead(_MaskXyzRegionHead):
    """Semantic-FPN head (reference fpn_mask_xyz_region_head.py, Panoptic
    FPN's scale heads): level i (stride 4 * 2^i) runs max(1, i) ConvModules,
    each followed by a 2x bilinear upsample (align_corners) for i > 0; the
    levels are summed at stride 4. Takes the list of the four stage
    features, finest first; single mask."""

    double_mask = False

    def __init__(self, in_dims: Sequence[int], feat_dim: int = 256,
                 feat_kernel_size: int = 3, norm: str = "GN", num_gn_groups: int = 32,
                 act: str = "gelu", out_kernel_size: int = 1, mask_num_classes: int = 1,
                 xyz_num_classes: int = 1, region_num_classes: int = 1,
                 mask_out_dim: int = 1, xyz_out_dim: int = 3, region_out_dim: int = 65,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(in_dims) != 4:
            raise ValueError(f"the FPN head takes the 4 stage features, not {len(in_dims)}")
        heads = []
        for i, c in enumerate(in_dims):          # stride 4 * 2^i
            layers = []
            for k in range(max(1, i)):
                layers.append(ConvModule(c if k == 0 else feat_dim, feat_dim, feat_kernel_size,
                                         norm=norm, num_gn_groups=num_gn_groups, act=act,
                                         dtype=dtype))
                if i > 0:
                    layers.append(Upsample2x("bilinear"))
            heads.append(nn.Sequential(*layers))
        self.scale_heads = nn.ModuleList(heads)
        self._init_out(feat_dim, out_kernel_size, mask_num_classes, xyz_num_classes,
                       region_num_classes, mask_out_dim, xyz_out_dim, region_out_dim)

    def _trunk(self, feats):
        if len(feats) != len(self.scale_heads):
            raise ValueError(f"the FPN head takes {len(self.scale_heads)} stage features")
        out = None
        for f, head in zip(feats, self.scale_heads):
            x = head(f)
            out = x if out is None else out + x
        return out
