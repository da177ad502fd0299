"""Rotation representations and allocentric/egocentric conversion.

Port of ``gdrnpp_bop2022_tpu/geometry/rotations.py`` (the functions the pose
decode and the train-time pose error need). Every function takes leading batch dimensions and runs in
the dtype of its input; the pose decode calls them in fp32.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def normalize(v: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=dim, keepdim=True).clamp_min(eps)


def rot6d_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> rotation matrix (..., 3, 3).

    The two 3-vectors are Gram-Schmidt orthonormalised into the first two
    COLUMNS of R (the reference's column-stacking convention).
    """
    x = normalize(d6[..., 0:3])
    z = normalize(torch.linalg.cross(x, d6[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def quat_to_mat(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Quaternion (w, x, y, z) of any norm (..., 4) -> rotation (..., 3, 3)."""
    s = 2.0 / (q * q).sum(-1).clamp_min(eps)
    w, x, y, z = q.unbind(-1)
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axangle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (..., 3, normalised) + angle (...,) -> quaternion (w, x, y, z)."""
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def allo_to_ego_quat_correction(translation: torch.Tensor,
                                 eps: float = 1e-4) -> torch.Tensor:
    """Quaternion rotating the optical axis (0, 0, 1) onto the object ray.

    translation (..., 3) -> (..., 4). The arccos argument is clamped to
    +-(1 - 1e-7) as in the JAX version.
    """
    obj_ray = translation / (torch.linalg.vector_norm(
        translation, dim=-1, keepdim=True) + eps)
    angle = torch.arccos(obj_ray[..., 2].clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    cam_ray = torch.zeros_like(obj_ray)
    cam_ray[..., 2] = 1.0
    axis = torch.linalg.cross(cam_ray, obj_ray, dim=-1)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + eps)
    return axangle_to_quat(axis, angle)


def allo_to_ego_mat(translation: torch.Tensor, rot_allo: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Allocentric rotations (..., 3, 3) -> egocentric, given translations."""
    q_corr = allo_to_ego_quat_correction(translation, eps=eps)
    return torch.matmul(quat_to_mat(q_corr), rot_allo)


def angular_distance(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle (radians) between batches of rotation matrices."""
    tr = (r1 * r2).sum(dim=(-2, -1))
    return torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0 + eps, 1.0 - eps))
