"""Top-down double-mask XYZ/region geometric head (reference names).

Port of ``gdrnpp_bop2022_tpu/models/heads/top_down_head.py::
TopDownDoubleMaskXyzRegionHead``. Layers sit in the reference's anonymous
``features`` ModuleList: per up-block [ConvTranspose2d, GroupNorm, act] for
"deconv" or [Upsample] for "bilinear"/"nearest", then ``num_conv_per_block``
ConvModules; then the shared ``out_layer`` conv.

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
from ..layers import Act, ConvModule, GroupNorm32, Upsample2x


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


class TopDownDoubleMaskXyzRegionHead(nn.Module):
    """Predicts (vis_mask, full_mask, coor_x, coor_y, coor_z, region), NCHW."""

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
        self.layout = [("mask", mask_out_dim, mask_num_classes),
                       ("xyz", xyz_out_dim, xyz_num_classes),
                       ("region", region_out_dim, region_num_classes)]
        layers = []
        c = in_dim
        for up in up_types:
            if up == "deconv":
                layers += [_Deconv(c, feat_dim, deconv_kernel_size, dtype),
                           GroupNorm32(num_gn_groups, feat_dim), Act(act)]
            else:
                layers.append(Upsample2x(up))
            c = feat_dim if up == "deconv" else c
            for _ in range(num_conv_per_block):
                layers.append(ConvModule(c, feat_dim, feat_kernel_size,
                                         norm=norm, num_gn_groups=num_gn_groups,
                                         act=act, dtype=dtype))
                c = feat_dim
        self.features = nn.ModuleList(layers)
        total = sum(d * n for _, d, n in self.layout)
        self.out_layer = nn.Conv2d(c, total, out_kernel_size,
                                   padding=(out_kernel_size - 1) // 2)
        # jax_channel[i] = ref_channel[perm[i]]
        perm = geo_out_channel_perm(mask_out_dim, xyz_out_dim, region_out_dim,
                                    mask_num_classes, xyz_num_classes,
                                    region_num_classes)
        self.register_buffer("out_perm", torch.as_tensor(perm), persistent=False)

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
        for layer in self.features:
            x = layer(x)
        outs = self._out_layer(x, labels)
        mask, xyz = outs["mask"], outs["xyz"]
        md = mask.shape[1]
        B, xc, H, W = xyz.shape
        xyz = xyz.reshape(B, 3, xc // 3, H, W)
        return {
            "vis_mask": mask[:, :md // 2],
            "full_mask": mask[:, md // 2:],
            "coor_x": xyz[:, 0],
            "coor_y": xyz[:, 1],
            "coor_z": xyz[:, 2],
            "region": outs["region"],
        }
