"""The SITE pose decode.

Port of ``gdrnpp_bop2022_tpu/geometry/se3.py``. The SITE (scale-invariant
translation estimation) decode turns the relative centroid offset and the
relative depth into an absolute translation, and the allocentric rotation
into an egocentric one.
"""

from __future__ import annotations

import torch

from .rotations import allo_to_ego_mat


def pose_from_centroid_z_rel(rot_allo, centroid_rel, z_rel, roi_cams,
                             roi_centers, resize_ratios, roi_whs,
                             eps: float = 1e-4, is_allo: bool = True,
                             z_type: str = "REL"):
    """SITE decode: (allo rotation, relative centroid, relative z) -> (R_ego, t).

    centroid_rel (B, 2) is in units of the bbox (w, h) and offset from the
    bbox centre; z = z_rel * resize_ratio when z_type is "REL".
    roi_cams are the full-image intrinsics (B, 3, 3).
    """
    z_rel = z_rel.reshape(-1)
    cx = centroid_rel[:, 0] * roi_whs[:, 0] + roi_centers[:, 0]
    cy = centroid_rel[:, 1] * roi_whs[:, 1] + roi_centers[:, 1]
    if z_type == "REL":
        z = z_rel * resize_ratios
    elif z_type == "ABS":
        z = z_rel
    else:
        raise ValueError(f"Unknown z_type: {z_type}")
    tx = z * (cx - roi_cams[:, 0, 2]) / roi_cams[:, 0, 0]
    ty = z * (cy - roi_cams[:, 1, 2]) / roi_cams[:, 1, 1]
    trans = torch.stack([tx, ty, z], dim=-1)
    rot_ego = allo_to_ego_mat(trans, rot_allo, eps=eps) if is_allo else rot_allo
    return rot_ego, trans


def pose_from_centroid_z_abs(rot_allo, centroid_abs, z_abs, roi_cams,
                             eps: float = 1e-4, is_allo: bool = True):
    """SITE decode with an absolute 2D centroid and absolute z."""
    z = z_abs.reshape(-1)
    tx = z * (centroid_abs[:, 0] - roi_cams[:, 0, 2]) / roi_cams[:, 0, 0]
    ty = z * (centroid_abs[:, 1] - roi_cams[:, 1, 2]) / roi_cams[:, 1, 1]
    trans = torch.stack([tx, ty, z], dim=-1)
    rot_ego = allo_to_ego_mat(trans, rot_allo, eps=eps) if is_allo else rot_allo
    return rot_ego, trans


def pose_from_trans(rot_allo, trans, eps: float = 1e-4, is_allo: bool = True):
    """Direct-translation decode."""
    rot_ego = allo_to_ego_mat(trans, rot_allo, eps=eps) if is_allo else rot_allo
    return rot_ego, trans
