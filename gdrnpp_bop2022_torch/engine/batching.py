"""Device-side ROI batch preparation for serving and training.

Port of ``gdrnpp_bop2022_tpu/engine/batching.py``: ``roi_coord_2d_from_grid``,
``roi_coord_2d_rel_from_grid``, ``compute_test_rois``, ``build_test_batch``,
``build_depth_rois`` for serving; ``build_train_batch_online`` (the online
ground truth: crops, kernel B2's depth + XYZ render at the crop-K, masks,
region labels, SITE targets), ``dzi_jitter_host`` (numpy, on the host) and
``trunc_mask_batch`` for training. The unique full images of a batch go to
the device once; each ROI samples its image by index.

Conventions (as in the reference):
  * scale = max(bw, bh) * dzi_pad_scale, clipped to max(im_H, im_W);
  * resize_ratio = out_res / scale;
  * roi_coord_2d is the [0, 1)-normalised full-image coordinate of each
    output pixel;
  * roi_cams stay the FULL-IMAGE intrinsics; the rasterizer uses the
    crop-K at out_res.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import centered_crop_K
from ..ops.crop import affine_grid_from_boxes, roi_crop_resize
from ..ops.rasterizer import render_depth_xyz
from ..ops.region import xyz_to_region


def roi_coord_2d_from_grid(grid: torch.Tensor, im_w: int, im_h: int) -> torch.Tensor:
    """Normalised source coords of each output pixel (grid / (W, H))."""
    return grid / torch.tensor([im_w, im_h], dtype=grid.dtype, device=grid.device)


def roi_coord_2d_rel_from_grid(grid: torch.Tensor, centers: torch.Tensor,
                               scales: torch.Tensor) -> torch.Tensor:
    """COORD_2D_TYPE "rel": (bbox_center - pixel) / scale."""
    return (centers[:, None, None, :] - grid) / scales[:, None, None, None].to(grid.dtype)


def compute_test_rois(images, img_idx, centers, scales, input_res: int,
                      output_res: int, pixel_mean, pixel_std,
                      coord_2d_type: str = "abs"):
    """Normalised ROI crops (B, in, in, 3) and coord-2d (B, out, out, 2)."""
    roi_img = roi_crop_resize(images, centers, scales, input_res,
                              img_idx=img_idx)
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=roi_img.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=roi_img.device)
    roi_img = (roi_img - mean) / std
    grid_out = affine_grid_from_boxes(centers.float(), scales.float(), output_res)
    im_h, im_w = images.shape[1], images.shape[2]
    if coord_2d_type == "rel":
        roi_coord_2d = roi_coord_2d_rel_from_grid(grid_out, centers.float(),
                                                  scales.float())
    elif coord_2d_type == "abs":
        roi_coord_2d = roi_coord_2d_from_grid(grid_out, im_w, im_h)
    else:
        raise ValueError(f"coord_2d_type={coord_2d_type!r}: abs | rel")
    return roi_img, roi_coord_2d


def build_test_batch(images, img_idx, boxes_xyxy, Ks, labels, extents,
                     input_res: int = 256, output_res: int = 64,
                     pixel_mean=(0.0, 0.0, 0.0), pixel_std=(255.0, 255.0, 255.0),
                     dzi_pad_scale: float = 1.5, coord_2d_type: str = "abs") -> dict:
    """Detections -> the batch dict that ``GDRN.forward`` takes.

    images (M, H, W, 3) uint8 or float, img_idx (B,), boxes_xyxy (B, 4),
    Ks (B, 3, 3) full-image intrinsics, labels (B,), extents (C, 3) bank.
    """
    im_h, im_w = images.shape[1], images.shape[2]
    boxes = boxes_xyxy.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = (x2 - x1).clamp_min(1.0)
    bh = (y2 - y1).clamp_min(1.0)
    centers = torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5], dim=-1)
    scales = (torch.maximum(bw, bh) * dzi_pad_scale).clamp_max(float(max(im_h, im_w)))
    roi_img, roi_coord_2d = compute_test_rois(
        images, img_idx, centers, scales, input_res, output_res, pixel_mean,
        pixel_std, coord_2d_type=coord_2d_type)
    return {
        "roi_img": roi_img,
        "roi_labels": labels.long(),
        "roi_coord_2d": roi_coord_2d,
        "roi_cams": Ks.float(),
        "roi_centers": centers,
        "roi_whs": torch.stack([bw, bh], dim=-1),
        "roi_extents": extents.float()[labels.long()],
        "resize_ratios": output_res / scales,
    }


def build_depth_rois(depths, img_idx, centers, scales, Ks, input_res: int = 256,
                     bp_depth: bool = True) -> torch.Tensor:
    """Backprojected depth ROIs for the RGB-D dual-stream model.

    depths (M, H, W) full-image depth in meters, img_idx (B,), centers
    (B, 2), scales (B,), Ks (B, 3, 3) full-image intrinsics. The depth is
    nearest-cropped per ROI and backprojected with the full-image K at the
    ROUNDED source pixel, which equals backproject-then-nearest-crop
    without a (M, H, W, 3) map. Returns (B, R, R, 3) camera-space XYZ in
    meters when bp_depth, else (B, R, R, 1) raw depth.
    """
    d = roi_crop_resize(depths[..., None], centers, scales, input_res,
                        method="nearest", img_idx=img_idx)[..., 0]    # (B, R, R)
    if not bp_depth:
        return d[..., None]
    grid = affine_grid_from_boxes(centers.float(), scales.float(), input_res)
    xs = torch.round(grid[..., 0])      # the pixel the nearest sampler took
    ys = torch.round(grid[..., 1])
    Ks = Ks.float()
    fx = Ks[:, 0, 0][:, None, None]
    fy = Ks[:, 1, 1][:, None, None]
    cx = Ks[:, 0, 2][:, None, None]
    cy = Ks[:, 1, 2][:, None, None]
    X = (xs - cx) / fx * d
    Y = (ys - cy) / fy * d
    return torch.stack([X, Y, d], dim=-1)


def build_train_batch_online(images, img_idx, centers, scales, bboxes_xyxy, Ks, labels,
                             gt_rots, gt_transes, mask_visib, mask_full, mask_idx,
                             verts, faces, fps_points, extents, input_res: int = 256,
                             output_res: int = 64,
                             pixel_mean=(0.0, 0.0, 0.0), pixel_std=(255.0, 255.0, 255.0),
                             xyz_bin: int = 0, mask_full_idx=None,
                             coord_2d_type: str = "abs", xyz_bp: bool = True) -> dict:
    """Training batch with ONLINE ground truth (the reference's
    engine_utils.batch_data_train_online), all on the images' device.

    images (M, H, W, 3), img_idx (B,), DZI-jittered centers (B, 2) and
    scales (B,), un-jittered bboxes_xyxy (B, 4) for the roi_wh targets, Ks
    (B, 3, 3) full-image, labels (B,), egocentric gt_rots (B, 3, 3) and
    gt_transes (B, 3), full-image masks mask_visib / mask_full (M', H, W)
    indexed by mask_idx (B,) (mask_full by mask_full_idx when given), and
    the model bank verts (C, V, 3), faces (C, F, 3), fps_points (C, R, 3),
    extents (C, 3). Depth and object XYZ are rendered through
    ``render_depth_xyz`` (kernel B2 in attribute mode on the card) at the
    crop-K; GT coords are normalised by extent + 0.5 (the reference's
    convention); the region labels use every keypoint of fps_points.
    """
    roi_img, roi_coord_2d = compute_test_rois(
        images, img_idx, centers, scales, input_res, output_res, pixel_mean,
        pixel_std, coord_2d_type=coord_2d_type)
    labels = labels.long()
    centers, scales = centers.float(), scales.float()
    gt_rots, gt_transes, Ks = gt_rots.float(), gt_transes.float(), Ks.float()

    # online GT: depth + xyz at the crop-K
    crop_Ks = centered_crop_K(Ks, centers, scales, output_res)
    depth, xyz = render_depth_xyz(verts[labels], faces[labels], gt_rots, gt_transes,
                                  crop_Ks, output_res, output_res, need_xyz=True)
    mask_obj = (depth > 1e-6).float()
    if xyz_bp:
        # XYZ_BP (the reference default): xyz = R^T (K^-1 [u, v, 1] d - t),
        # the rendered depth backprojected with the crop-K; pixel centres at
        # integer coordinates, as the rasterizer's grid
        u = torch.arange(output_res, dtype=torch.float32, device=depth.device)
        py, px = torch.meshgrid(u, u, indexing="ij")
        fx = crop_Ks[:, 0, 0][:, None, None]
        fy = crop_Ks[:, 1, 1][:, None, None]
        cx = crop_Ks[:, 0, 2][:, None, None]
        cy = crop_Ks[:, 1, 2][:, None, None]
        X = (px[None] - cx) / fx * depth
        Y = (py[None] - cy) / fy * depth
        p_cam = torch.stack([X, Y, depth], dim=-1)
        p_obj = torch.einsum("bijc,bck->bijk", p_cam - gt_transes[:, None, None, :], gt_rots)
        xyz = p_obj * mask_obj[..., None]

    # masks: the dataset's full-image masks, nearest-cropped
    gt_mask_visib = roi_crop_resize(mask_visib[..., None], centers, scales, output_res,
                                    method="nearest", img_idx=mask_idx)[..., 0]
    gt_mask_full = roi_crop_resize(
        mask_full[..., None], centers, scales, output_res, method="nearest",
        img_idx=mask_idx if mask_full_idx is None else mask_full_idx)[..., 0]
    gt_mask_trunc = gt_mask_visib * mask_obj      # visib and rendered

    gt_region = xyz_to_region(xyz, fps_points[labels], mask=mask_obj)
    roi_extents = extents.float()[labels]
    xyz_norm = (xyz / roi_extents[:, None, None, :] + 0.5) * mask_obj[..., None]

    # SITE targets: relative centroid offset and relative z
    x1, y1, x2, y2 = bboxes_xyxy.float().unbind(-1)
    bw = (x2 - x1).clamp_min(1.0)
    bh = (y2 - y1).clamp_min(1.0)
    proj_x = Ks[:, 0, 0] * gt_transes[:, 0] / gt_transes[:, 2] + Ks[:, 0, 2]
    proj_y = Ks[:, 1, 1] * gt_transes[:, 1] / gt_transes[:, 2] + Ks[:, 1, 2]
    delta_c = torch.stack([proj_x, proj_y], dim=-1) - centers
    resize_ratios = output_res / scales
    trans_ratio = torch.stack([delta_c[:, 0] / bw, delta_c[:, 1] / bh,
                               gt_transes[:, 2] / resize_ratios], dim=-1)
    batch = {
        "roi_img": roi_img,
        "roi_labels": labels,
        "roi_coord_2d": roi_coord_2d,
        "roi_cams": Ks,
        "roi_centers": centers,
        "roi_whs": torch.stack([bw, bh], dim=-1),
        "roi_extents": roi_extents,
        "resize_ratios": resize_ratios,
        "gt_xyz": xyz_norm,
        "gt_mask_trunc": gt_mask_trunc,
        "gt_mask_visib": gt_mask_visib,
        "gt_mask_obj": mask_obj,
        "gt_mask_full": gt_mask_full,
        "gt_region": gt_region,
        "gt_rot": gt_rots,
        "gt_trans": gt_transes,
        "gt_trans_ratio": trans_ratio,
    }
    if xyz_bin > 0:
        # normalised coords in bins; bin xyz_bin is the background
        binned = (xyz_norm * xyz_bin).long().clamp(0, xyz_bin - 1)
        bg = (mask_obj < 0.5)[..., None].expand_as(binned)
        batch["gt_xyz_bin"] = torch.where(bg, torch.full_like(binned, xyz_bin), binned)
    return batch


def dzi_jitter_host(rng, bboxes_xyxy, im_w, im_h, pad_scale=1.5, scale_ratio=0.25,
                    shift_ratio=0.25, dzi_type="uniform"):
    """Host-side DZI (dynamic zoom-in) bbox jitter from a numpy RandomState
    (reference core/base_data_loader.py aug_bbox_DZI :188-231), the JAX
    package's four types draw for draw:
      uniform:   center += uniform(-shift, shift) * (bw, bh);
                 scale = max(bw, bh) * (1 + uniform(-r, r)) * pad_scale;
      roi10d:    each box corner shifted by uniform(-0.15, 0.15) of the side,
                 clipped to the image; scale = max side * pad_scale;
      truncnorm: uniform's formula with the jitters drawn from a +-2-sigma
                 truncated normal (sigma = ratio / 2);
      none:      center/scale of the box, no pad_scale.
    Scales are clipped to max(im_w, im_h). Returns float32 (centers (B, 2),
    scales (B,)).
    """
    b = np.asarray(bboxes_xyxy, np.float32)
    bw = np.maximum(b[:, 2] - b[:, 0], 1.0)
    bh = np.maximum(b[:, 3] - b[:, 1], 1.0)
    cx = (b[:, 0] + b[:, 2]) * 0.5
    cy = (b[:, 1] + b[:, 3]) * 0.5
    n = len(b)

    def trunc_std_normal(size, lo=-2.0, hi=2.0):
        # rejection-sampled standard normal truncated to [lo, hi]
        out = rng.randn(size)
        bad = (out < lo) | (out > hi)
        while bad.any():
            out[bad] = rng.randn(int(bad.sum()))
            bad = (out < lo) | (out > hi)
        return out

    if dzi_type in ("uniform", "truncnorm"):
        if dzi_type == "uniform":
            scale_jit = 1.0 + scale_ratio * rng.uniform(-1, 1, n)
            shift_x = shift_ratio * rng.uniform(-1, 1, n)
            shift_y = shift_ratio * rng.uniform(-1, 1, n)
        else:
            scale_jit = 1.0 + (scale_ratio / 2.0) * trunc_std_normal(n)
            shift_x = (shift_ratio / 2.0) * trunc_std_normal(n)
            shift_y = (shift_ratio / 2.0) * trunc_std_normal(n)
        centers = np.stack([cx + shift_x * bw, cy + shift_y * bh], axis=-1)
        scales = np.maximum(bw, bh) * scale_jit * pad_scale
    elif dzi_type == "roi10d":
        x1 = np.clip(b[:, 0] + bw * rng.uniform(-0.15, 0.15, n), 0, im_w)
        x2 = np.clip(b[:, 2] + bw * rng.uniform(-0.15, 0.15, n), 0, im_w)
        y1 = np.clip(b[:, 1] + bh * rng.uniform(-0.15, 0.15, n), 0, im_h)
        y2 = np.clip(b[:, 3] + bh * rng.uniform(-0.15, 0.15, n), 0, im_h)
        centers = np.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5], axis=-1)
        scales = np.maximum(np.maximum(y2 - y1, x2 - x1), 1.0) * pad_scale
    elif dzi_type == "none":
        centers = np.stack([cx, cy], axis=-1)
        scales = np.maximum(bw, bh)
    else:
        raise ValueError(dzi_type)
    scales = np.minimum(scales, float(max(im_w, im_h)))
    return centers.astype(np.float32), scales.astype(np.float32)


def trunc_mask_batch(masks: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """Foreground truncation on the device: blank one side of each mask's
    bbox (reference trunc_mask, base_data_loader.py:454-478). draws (B, 2)
    are the two pre-drawn uniforms (branch selector, cut position), so the
    host loader's cut and this one agree for the same draws.

    masks (B, H, W) in {0, 1} of any dtype. Returns float32.
    """
    B, H, W = masks.shape
    m = masks > 0.5
    rows = m.any(dim=2)                      # (B, H)
    cols = m.any(dim=1)                      # (B, W)
    nonempty = rows.any(dim=1)
    x1 = rows.float().argmax(dim=1).float()
    x2 = (H - 1 - rows.flip(1).float().argmax(dim=1)).float()
    y1 = cols.float().argmax(dim=1).float()
    y2 = (W - 1 - cols.flip(1).float().argmax(dim=1)).float()
    c_h = 0.5 * (x1 + x2)
    c_w = 0.5 * (y1 + y2)
    draws = draws.float()
    rnd, u = draws[:, 0], draws[:, 1]
    cut_top = torch.floor(x1 + u * (c_h - x1))       # rows <  cut removed
    cut_bot = torch.floor(c_h + u * (x2 - c_h))      # rows >= cut removed
    cut_left = torch.floor(y1 + u * (c_w - y1))      # cols <  cut removed
    cut_right = torch.floor(c_w + u * (y2 - c_w))    # cols >= cut removed
    ri = torch.arange(H, dtype=torch.float32, device=masks.device)[None, :, None]
    ci = torch.arange(W, dtype=torch.float32, device=masks.device)[None, None, :]

    def bc(x):
        return x[:, None, None]

    keep = torch.where(
        bc(rnd < 0.2), ri >= bc(cut_top),
        torch.where(bc(rnd < 0.4), ri < bc(cut_bot),
                    torch.where(bc(rnd < 0.6), ci >= bc(cut_left),
                                torch.where(bc(rnd < 0.8), ci < bc(cut_right),
                                            torch.ones_like(ri >= 0)))))
    out = torch.where(nonempty[:, None, None], m & keep, m)
    return out.float()
