"""Camera geometry, batched: crop intrinsics, projection, backprojection.

Port of ``gdrnpp_bop2022_tpu/geometry/camera.py``: ``get_K_crop_resize`` and
``centered_crop_K`` (the crop-K the rasterizer renders with; the skew term
``K[0, 1]`` scales with x like the focal length), ``project_points``,
``backproject_depth``, ``calc_xyz_from_depth`` and ``get_2d_coord_grid``.
The JAX version's HIGHEST-precision einsums are written here as fp32 sums
over j = 0, 1, 2 (``apply3``), so no product goes through TF32 on the card.
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


def apply3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v for M (B, 3, 3) and points v (B, ..., 3), as fp32 sums."""
    M = M.reshape(M.shape[:1] + (1,) * (v.dim() - 2) + (3, 3))
    return (M[..., 0] * v[..., 0:1] + M[..., 1] * v[..., 1:2]
            + M[..., 2] * v[..., 2:3])


def project_points(pts: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Model points (B, N, 3) under pose (R (B, 3, 3), t (B, 3)) and
    intrinsics K (B, 3, 3) -> pixels (B, N, 2)."""
    uvw = apply3(K, apply3(R, pts) + t[:, None, :])
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)


def backproject_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) -> camera-space points (B, H, W, 3) (zero where the
    depth is zero)."""
    B, H, W = depth.shape
    us = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, None, :]
    vs = torch.arange(H, dtype=depth.dtype, device=depth.device)[None, :, None]
    fx, fy = K[:, 0, 0, None, None], K[:, 1, 1, None, None]
    px, py = K[:, 0, 2, None, None], K[:, 1, 2, None, None]
    return torch.stack([(us - px) * depth / fx, (vs - py) * depth / fy, depth], dim=-1)


def calc_xyz_from_depth(depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) -> object-space coordinates (B, H, W, 3): backproject,
    then (R, t)^-1; zero where the depth is not above 1e-6."""
    pts_cam = backproject_depth(depth, K) - t[:, None, None, :]
    pts_obj = apply3(R.transpose(1, 2), pts_cam)
    return torch.where((depth > 1e-6)[..., None], pts_obj, 0.0)


def get_2d_coord_grid(width: int, height: int, low: float = 0.0, high: float = 1.0,
                      fmt: str = "HWC", dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalised coordinate map over [low, high) (``endpoint=False``
    linspace, as ``jnp.linspace`` computes it: low (1 - s) + high s with
    s = i / n): (H, W, 2) with channels (x, y), or (2, H, W) for "CHW"."""
    def lin(n):
        s = torch.arange(n, dtype=dtype, device=device) / n
        return low * (1 - s) + high * s
    x, y = lin(width), lin(height)
    out = torch.stack([x[None, :].expand(height, width), y[:, None].expand(height, width)],
                      dim=-1)
    return out.permute(2, 0, 1).contiguous() if fmt == "CHW" else out
