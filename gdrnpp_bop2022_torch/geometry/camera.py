"""Crop-camera intrinsics, batched.

Port of ``gdrnpp_bop2022_tpu/geometry/camera.py::get_K_crop_resize`` and
``centered_crop_K`` (the crop-K the rasterizer renders with). The skew
term ``K[0, 1]`` scales with x like the focal length.
"""

from __future__ import annotations

import torch


def get_K_crop_resize(K: torch.Tensor, boxes: torch.Tensor, out_size) -> torch.Tensor:
    """Intrinsics of an axis-aligned crop + resize.

    K (B, 3, 3) full-image intrinsics, boxes (B, 4) crop boxes (x1, y1, x2,
    y2) in pixels, out_size (out_w, out_h). Returns (B, 3, 3).
    """
    out_w, out_h = out_size
    crop_w = boxes[:, 2] - boxes[:, 0]
    crop_h = boxes[:, 3] - boxes[:, 1]
    sx = out_w / crop_w
    sy = out_h / crop_h
    fx = K[:, 0, 0] * sx
    fy = K[:, 1, 1] * sy
    skew = K[:, 0, 1] * sx
    px = (K[:, 0, 2] - boxes[:, 0]) * sx
    py = (K[:, 1, 2] - boxes[:, 1]) * sy
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, skew, px], dim=-1)
    row1 = torch.stack([zeros, fy, py], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def centered_crop_K(K: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                    out_res: int) -> torch.Tensor:
    """Crop-K of a square crop of side ``scales`` centred at ``centers``,
    resized to out_res. K (B, 3, 3), centers (B, 2), scales (B,)."""
    x1 = centers[:, 0] - scales * 0.5
    y1 = centers[:, 1] - scales * 0.5
    boxes = torch.stack([x1, y1, x1 + scales, y1 + scales], dim=-1)
    return get_K_crop_resize(K, boxes, (out_res, out_res))
