"""Post-processing from dense predictions: PnP and depth refinement.

Port of ``gdrnpp_bop2022_tpu/eval/pnp_eval.py``:

  * ``dense_correspondences`` (reference get_img_model_points_with_coords2d,
    gdrn_evaluator.py:115-153): every pixel is a (2D pixel, 3D model point)
    pair, with a validity mask where the reference selects;
  * ``pose_from_dense_ransac`` (process_pnp_ransac, gdrn_evaluator.py:373-459);
  * ``pose_from_dense_uncertainty`` (un_pnp_utils.py: weighted LM with the
    mask probability as confidence);
  * ``pose_from_dense_net_iter`` (process_net_and_pnp, gdrn_evaluator.py:
    241-371, pnp_type "iter");
  * ``depth_refine_batch`` (process_depth_refine, gdrn_evaluator.py:461-573).
"""

from __future__ import annotations

import torch

from ..geometry.camera import centered_crop_K
from ..ops.pnp import lm_refine_pnp, normalize_points_2d, ransac_pnp, uncertainty_pnp
from ..ops.rasterizer import render_depth_xyz


def dense_correspondences(mask_prob, xyz_pred, coord_2d, im_wh, extents,
                          mask_thr: float = 0.5):
    """All-pixel 2D-3D correspondences with validity weights.

    mask_prob (B, H, W), xyz_pred (B, H, W, 3) in [0, 1], coord_2d
    (B, H, W, 2) normalised full-image coords, im_wh (B, 2), extents (B, 3).
    Returns pts2d (B, P, 2), pts3d (B, P, 3), valid (B, P), conf (B, P).
    """
    B, H, W = mask_prob.shape
    xyz = (xyz_pred - 0.5) * extents[:, None, None, :]
    pts2d = coord_2d * im_wh[:, None, None, :]
    eps = 1e-4 * extents[:, None, None, :]
    valid = (mask_prob > mask_thr) & (xyz.abs() > eps).all(dim=-1)
    P = H * W
    return (pts2d.reshape(B, P, 2), xyz.reshape(B, P, 3), valid.reshape(B, P),
            mask_prob.reshape(B, P))


def pose_from_dense_ransac(mask_prob, xyz_pred, coord_2d, im_wh, extents, Ks,
                           n_hyps: int = 128, generator=None, idx=None):
    """USE_PNP=ransac_pnp: RANSAC PnP on the dense correspondences.
    Returns (R (B, 3, 3), t (B, 3), inlier_frac (B,))."""
    pts2d, pts3d, valid, _ = dense_correspondences(mask_prob, xyz_pred, coord_2d, im_wh,
                                                   extents)
    return ransac_pnp(pts3d, pts2d, Ks, mask=valid, n_hyps=n_hyps, generator=generator,
                      idx=idx)


def pose_from_dense_uncertainty(mask_prob, xyz_pred, coord_2d, im_wh, extents, Ks,
                                R0=None, t0=None):
    """Uncertainty PnP: the mask probability as per-point confidence; LM
    from (R0, t0) when given, else from the weighted DLT."""
    pts2d, pts3d, valid, conf = dense_correspondences(mask_prob, xyz_pred, coord_2d,
                                                      im_wh, extents)
    w = torch.where(valid, conf, torch.zeros_like(conf))
    if R0 is not None and t0 is not None:
        return lm_refine_pnp(R0, t0, pts3d, normalize_points_2d(pts2d, Ks), weights=w,
                             iters=15)
    return uncertainty_pnp(pts3d, pts2d, w, Ks)


def pose_from_dense_net_iter(mask_prob, xyz_pred, coord_2d, im_wh, extents, Ks, R0, t0,
                             iters: int = 20, trans_diff_max: float = 1.0,
                             min_points: int = 4):
    """USE_PNP=net_iter_pnp: LM on the reprojection error seeded at the
    network's pose (cv2.solvePnP SOLVEPNP_ITERATIVE with useExtrinsicGuess),
    with the reference's two guards (gdrn_evaluator.py:346-357): a
    translation that moved more than ``trans_diff_max`` m keeps the net's t
    (the rotation stays refined); fewer than ``min_points`` valid
    correspondences keep the net's pose."""
    pts2d, pts3d, valid, _ = dense_correspondences(mask_prob, xyz_pred, coord_2d, im_wh,
                                                   extents)
    R, t = lm_refine_pnp(R0, t0, pts3d, normalize_points_2d(pts2d, Ks),
                         weights=valid.to(pts3d.dtype), iters=iters)
    moved = torch.linalg.vector_norm(t - t0, dim=-1, keepdim=True) > trans_diff_max
    t = torch.where(moved, t0, t)
    few = valid.sum(-1) < min_points
    return torch.where(few[:, None, None], R0, R), torch.where(few[:, None], t0, t)


def depth_refine_batch(rots, transes, mask_prob, xyz_pred, depth_sensor, Ks, centers,
                       scales, verts, faces, extents, iters: int = 2,
                       threshold: float = 0.8, out_res: int = 64,
                       render=render_depth_xyz):
    """Refine translations against the sensor depth; returns t (B, 3).

    rots (B, 3, 3) (kept fixed), transes (B, 3), mask_prob (B, H, W),
    xyz_pred (B, H, W, 3) in [0, 1], depth_sensor (B, H, W) cropped to
    out_res, Ks (B, 3, 3) full-image intrinsics, centers (B, 2), scales
    (B,), verts (B, V, 3) / faces (B, F, 3) per-ROI meshes, extents (B, 3).

    Each iteration renders depth at the crop-K (B2 in depth-only mode
    through ``render``), builds the confidence |xyz| * mask on pixels both
    rendered and sensed, takes the median depth difference over the
    pixels above ``threshold`` of the peak confidence (a masked median by
    sort), and moves t along the confidence-weighted mean ray by it.
    """
    B, H, W = mask_prob.shape
    crop_Ks = centered_crop_K(Ks, centers, scales, out_res)
    xyz_abs = (xyz_pred - 0.5) * extents[:, None, None, :]
    query_base = torch.sqrt((xyz_abs * xyz_abs).sum(-1)) * mask_prob   # (B, H, W)
    sensor_mask = depth_sensor > 0
    ys = torch.arange(H, dtype=torch.float32, device=mask_prob.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=mask_prob.device)[None, None, :]

    t = transes
    for _ in range(iters):
        depth_ren, _ = render(verts, faces, rots, t, crop_Ks, H, W, need_xyz=False)
        ren_mask = depth_ren > 0
        q = query_base * ren_mask * sensor_mask
        qsum = q.sum(dim=(1, 2), keepdim=True)
        qn = q / torch.clamp_min(qsum, 1e-12)
        support = qn > qn.amax(dim=(1, 2), keepdim=True) * threshold

        # masked median of the depth difference over the support
        diff = depth_sensor - depth_ren
        d_sorted = torch.sort(torch.where(support, diff, torch.full_like(diff, 1e6))
                              .reshape(B, -1), dim=1).values
        n_sup = support.sum(dim=(1, 2))
        depth_adj = torch.gather(d_sorted, 1, (n_sup // 2)[:, None])[:, 0]
        depth_adj = torch.where(n_sup > 0, depth_adj, torch.zeros_like(depth_adj))

        # confidence-weighted mean ray through the crop camera
        mean_x = (xs * qn).sum(dim=(1, 2))
        mean_y = (ys * qn).sum(dim=(1, 2))
        rx = (mean_x - crop_Ks[:, 0, 2]) / crop_Ks[:, 0, 0]
        ry = (mean_y - crop_Ks[:, 1, 2]) / crop_Ks[:, 1, 1]
        ray = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
        ok = (qsum[:, 0, 0] > 0) & (n_sup > 0)
        t = t + torch.where(ok[:, None], ray * depth_adj[:, None], torch.zeros_like(ray))
    return t
