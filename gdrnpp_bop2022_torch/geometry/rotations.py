"""Rotation representations and allocentric/egocentric conversion.

Port of ``gdrnpp_bop2022_tpu/geometry/rotations.py``: rot6d, quaternions,
allo/ego, the geodesic angle, random rotations and the so(3) / log-quaternion
maps. Every function takes leading batch dimensions and runs in the dtype and
on the device of its input; the pose decode calls them in fp32. ``matmul3``
writes a 3x3 product as fp32 sums (the JAX version's HIGHEST-precision
matmuls), out of TF32's reach on any device.
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


def mat_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> 6D rep (..., 6): the first two columns."""
    return torch.cat([rot[..., :, 0], rot[..., :, 1]], dim=-1)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3, 3) matrices as fp32 sums of products, j = 0, 1, 2."""
    return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


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


def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (w, x, y, z) with w >= 0.

    Branch-free as in the JAX version: the four candidate constructions are
    built and the one with the largest denominator is taken (``argmax``:
    ties to the first, as ``jnp.argmax``)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    qs = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1),
    ], dim=-2)                                                  # (..., 4 candidates, 4)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                          1.0 + m22 - m00 - m11], dim=-1)
    idx = scores.argmax(dim=-1)
    q = torch.take_along_dim(qs, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


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


def ego_to_allo_mat(translation: torch.Tensor, rot_ego: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """Inverse of ``allo_to_ego_mat`` (builds allocentric ground truth)."""
    r_corr = quat_to_mat(allo_to_ego_quat_correction(translation, eps=eps))
    return matmul3(r_corr.transpose(-1, -2), rot_ego)


def angular_distance(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle (radians) between batches of rotation matrices."""
    tr = (r1 * r2).sum(dim=(-2, -1))
    return torch.arccos(((tr - 1.0) * 0.5).clamp(-1.0 + eps, 1.0 - eps))


def random_rotations(generator: torch.Generator, n: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """n uniform random rotations (n, 3, 3): normalised Gaussian quaternions
    drawn from ``generator`` (on ``device``, else the generator's)."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype,
                    device=device if device is not None else generator.device)
    return quat_to_mat(normalize(q))


# so(3) exp / log and log-quaternions (reference core/utils/lie_algebra.py,
# quaternion_lf.py). Branch-free: the small-angle limits are where-guarded
# Taylor terms, and every square root is guarded BEFORE it is differentiated,
# so the maps and their gradients stay finite at the identity.

def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def lie_vec_to_rot(vec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SO(3) exponential map, axis-angle (..., 3) -> (..., 3, 3): Rodrigues'
    R = I + sin(t)/t [v]x + (1 - cos t)/t^2 [v]x^2, with the limits 1 and 1/2
    near t = 0."""
    t2 = (vec * vec).sum(-1)
    t = torch.sqrt(t2.clamp_min(eps * eps))
    small = t2 < eps
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2.clamp_min(eps * eps))
    K = _skew(vec)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * matmul3(K, K)


def quat_to_lie_vec(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) (..., 4) -> axis-angle vector (..., 3)."""
    q = q * torch.sign(torch.where(q[..., 0:1] == 0, 1.0, q[..., 0:1]))
    s2 = (q[..., 1:] * q[..., 1:]).sum(-1)
    small = s2 < eps * eps
    sin_half = torch.sqrt(torch.where(small, 1.0, s2))
    half = torch.where(small, 0.0, torch.atan2(sin_half, q[..., 0]))
    # 2 half / sin(half), with the limit 2 at half -> 0
    k = torch.where(small, 2.0 + (2.0 / 6.0) * half * half, 2.0 * half / sin_half)
    return q[..., 1:] * k[..., None]


def rot_to_lie_vec(rot: torch.Tensor) -> torch.Tensor:
    """SO(3) log map (..., 3, 3) -> (..., 3), through the quaternion."""
    return quat_to_lie_vec(mat_to_quat(rot))


def qlog(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log of a unit quaternion: the imaginary part (..., 3), half the
    axis-angle vector."""
    return 0.5 * quat_to_lie_vec(q, eps=eps)


def qexp(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Exp of a pure-imaginary quaternion (..., 3) -> unit (w, x, y, z)."""
    t2 = (v * v).sum(-1, keepdim=True)
    small = t2 < eps * eps
    t = torch.sqrt(torch.where(small, 1.0, t2))
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    w = torch.where(small, 1.0 - t2 / 2.0, torch.cos(t))
    return torch.cat([w, v * sinc], dim=-1)


def quat_rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by unit quaternions (..., 4):
    v + 2 (q_w (q_v x v) + q_v x (q_v x v))."""
    qv = q[..., 1:]
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (q[..., 0:1] * uv + uuv)


def quat_angular_distance(q1: torch.Tensor, q2: torch.Tensor,
                          eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between unit quaternions, invariant to their sign."""
    d = (q1 * q2).sum(-1).abs()
    return 2.0 * torch.arccos(d.clamp(0.0, 1.0 - eps))
