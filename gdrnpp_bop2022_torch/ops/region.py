"""Surface-region labels: each XYZ-map pixel gets its nearest FPS keypoint.

Port of ``gdrnpp_bop2022_tpu/ops/region.py`` (reference
core/utils/data_utils.py:267-302), used for the region ground truth of the
online training batch. The squared distances keep the JAX package's
expanded form ``|p|^2 + |k|^2 - 2 p.k`` (one batched matmul) and ``argmin``
takes the first keypoint on a tie, so labels agree with it away from
near-ties.
"""

from __future__ import annotations

import torch


def xyz_to_region(xyz: torch.Tensor, fps_points: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Label each pixel with its closest keypoint id, 1-based.

    xyz (B, H, W, 3) object-space coordinates; fps_points (B, R, 3)
    per-ROI keypoints; mask (B, H, W) foreground (background gets 0; by
    default the pixels whose xyz is not all zero). Returns (B, H, W) int64
    labels in [0, R].
    """
    B, H, W, _ = xyz.shape
    flat = xyz.reshape(B, H * W, 3).float()
    kp = fps_points.float()
    n1 = (flat * flat).sum(-1)                                  # (B, P)
    n2 = (kp * kp).sum(-1)                                      # (B, R)
    cross = torch.bmm(flat, kp.transpose(1, 2))                 # (B, P, R)
    d = n1[:, :, None] + n2[:, None, :] - 2.0 * cross
    label = (torch.argmin(d, dim=-1) + 1).reshape(B, H, W)
    if mask is None:
        mask = (xyz != 0.0).any(dim=-1)
    return torch.where(mask.bool(), label, torch.zeros_like(label))
