"""Batched ROI crop-resize.

Port of ``gdrnpp_bop2022_tpu/ops/crop.py`` (``affine_grid_from_boxes`` and
the gather form of ``roi_crop_resize``). Sampling follows cv2.warpAffine's
convention: integer pixel centres, zero outside the image. The JAX
package's ``roi_crop_resize_mxu`` computes the same bilinear crop as two
dense matmuls for the TPU's matrix unit; here it is one gather.
"""

from __future__ import annotations

from typing import Optional

import torch


def affine_grid_from_boxes(centers: torch.Tensor, scales: torch.Tensor,
                           out_res: int) -> torch.Tensor:
    """Source (x, y) of each output pixel of square centre/scale crops.

    Output pixel (i, j) samples ``center + (j - out/2) * scale/out`` (rows
    likewise). centers (B, 2), scales (B,) -> (B, out_res, out_res, 2).
    """
    step = scales[:, None] / out_res
    offset = torch.arange(out_res, dtype=centers.dtype, device=centers.device) \
        - out_res * 0.5
    xs = centers[:, 0:1] + offset[None, :] * step               # (B, R)
    ys = centers[:, 1:2] + offset[None, :] * step
    B = centers.shape[0]
    grid_x = xs[:, None, :].expand(B, out_res, out_res)
    grid_y = ys[:, :, None].expand(B, out_res, out_res)
    return torch.stack([grid_x, grid_y], dim=-1)


def _taps(imgs, img_idx, yi, xi):
    """imgs (M, H, W, C); per-ROI image index (B,); yi, xi (B, R, R) int ->
    (B, R, R, C) fp32, zero where (yi, xi) falls outside the image."""
    H, W = imgs.shape[1], imgs.shape[2]
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    v = imgs[img_idx[:, None, None], yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
    return v.float() * valid[..., None]


def roi_crop_resize(imgs: torch.Tensor, centers: torch.Tensor,
                    scales: torch.Tensor, out_res: int,
                    method: str = "bilinear",
                    img_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop square ROIs (centre/scale) and resize to out_res, in fp32.

    imgs (B, H, W, C) holds one image per ROI; or, with ``img_idx`` (B,),
    a stack (M, H, W, C) that each ROI indexes, so the full images are
    never copied per ROI. Returns (B, out_res, out_res, C).
    """
    grid = affine_grid_from_boxes(centers.float(), scales.float(), out_res)
    if img_idx is None:
        img_idx = torch.arange(imgs.shape[0], device=imgs.device)
    img_idx = img_idx.long()
    x, y = grid[..., 0], grid[..., 1]
    if method == "nearest":
        # round half to even, as jnp.round
        return _taps(imgs, img_idx, torch.round(y).long(), torch.round(x).long())
    if method != "bilinear":
        raise ValueError(f"Unknown crop method: {method}")
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    top = (_taps(imgs, img_idx, y0i, x0i) * (1 - wx)
           + _taps(imgs, img_idx, y0i, x0i + 1) * wx)
    bot = (_taps(imgs, img_idx, y0i + 1, x0i) * (1 - wx)
           + _taps(imgs, img_idx, y0i + 1, x0i + 1) * wx)
    return top * (1 - wy) + bot * wy
