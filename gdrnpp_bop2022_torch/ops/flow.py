"""Optical-flow ground truth between two poses of a depth map.

Port of ``gdrnpp_bop2022_tpu/ops/flow.py`` (reference core/csrc/flow,
DeepIM heritage): backproject the depth at pose 1, move the points by the
relative transform, reproject. The rotation is applied as fp32 sums
(``geometry.camera.apply3``), never TF32.
"""

from __future__ import annotations

import torch

from ..geometry.camera import apply3, backproject_depth


def flow_from_depth(depth1: torch.Tensor, K: torch.Tensor, R_rel: torch.Tensor,
                    t_rel: torch.Tensor):
    """depth1 (B, H, W) at pose 1, K (B, 3, 3), pose 2 = R_rel (B, 3, 3) @
    pose 1 + t_rel (B, 3). Returns (flow (B, H, W, 2) in pixels, zero where
    invalid; valid (B, H, W): depth above 1e-6)."""
    pts2 = apply3(R_rel, backproject_depth(depth1, K)) + t_rel[:, None, None, :]
    z2 = pts2[..., 2].clamp_min(1e-9)
    u2 = K[:, 0, 0, None, None] * pts2[..., 0] / z2 + K[:, 0, 2, None, None]
    v2 = K[:, 1, 1, None, None] * pts2[..., 1] / z2 + K[:, 1, 2, None, None]
    H, W = depth1.shape[1:3]
    us = torch.arange(W, dtype=depth1.dtype, device=depth1.device)[None, None, :]
    vs = torch.arange(H, dtype=depth1.dtype, device=depth1.device)[None, :, None]
    valid = depth1 > 1e-6
    flow = torch.stack([u2 - us, v2 - vs], dim=-1)
    return torch.where(valid[..., None], flow, 0.0), valid
