"""YOLOX PAFPN neck: a top-down FPN then a bottom-up PAN path.

Port of ``gdrnpp_bop2022_tpu/models/yolox/pafpn.py`` under the reference's
names (det/yolox/models/yolo_pafpn.py: ``backbone``, ``lateral_conv0``,
``C3_p4``, ``reduce_conv1``, ``C3_p3``, ``bu_conv2``, ``C3_n3``,
``bu_conv1``, ``C3_n4``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .darknet import BaseConv, CSPDarknet, CSPLayer


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x: output pixel i reads input pixel i // 2, as
    ``jax.image.resize(..., "nearest")`` does for an exact 2x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    def __init__(self, dep_mul: float = 1.0, wid_mul: float = 1.0,
                 depthwise: bool = False, norm: str = "GN",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = CSPDarknet(dep_mul, wid_mul, depthwise, norm=norm, dtype=dtype)
        c3, c4, _ = self.backbone.out_channels
        w = lambda c: int(c * wid_mul)                      # noqa: E731
        d = max(round(dep_mul * 3), 1)
        kw = dict(shortcut=False, depthwise=depthwise, norm=norm, dtype=dtype)
        self.lateral_conv0 = BaseConv(self.backbone.out_channels[2], w(512), 1,
                                      norm=norm, dtype=dtype)
        self.C3_p4 = CSPLayer(w(512) + c4, w(512), d, **kw)
        self.reduce_conv1 = BaseConv(w(512), w(256), 1, norm=norm, dtype=dtype)
        self.C3_p3 = CSPLayer(w(256) + c3, w(256), d, **kw)
        self.bu_conv2 = BaseConv(w(256), w(256), 3, 2, norm=norm, dtype=dtype)
        self.C3_n3 = CSPLayer(2 * w(256), w(512), d, **kw)
        self.bu_conv1 = BaseConv(w(512), w(512), 3, 2, norm=norm, dtype=dtype)
        self.C3_n4 = CSPLayer(2 * w(512), w(1024), d, **kw)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x):
        """x (B, 3, H, W) -> the strides 8, 16 and 32 outputs."""
        c3, c4, c5 = self.backbone(x)
        p5 = self.lateral_conv0(c5)
        f4 = self.C3_p4(torch.cat([upsample2x(p5), c4], dim=1))
        p4 = self.reduce_conv1(f4)
        out3 = self.C3_p3(torch.cat([upsample2x(p4), c3], dim=1))
        out4 = self.C3_n3(torch.cat([self.bu_conv2(out3), p4], dim=1))
        out5 = self.C3_n4(torch.cat([self.bu_conv1(out4), p5], dim=1))
        return out3, out4, out5
