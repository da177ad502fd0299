"""Device-side ROI batch preparation for serving.

Port of the test-time part of ``gdrnpp_bop2022_tpu/engine/batching.py``
(``roi_coord_2d_from_grid``, ``roi_coord_2d_rel_from_grid``,
``compute_test_rois``, ``build_test_batch``, ``build_depth_rois``). The
unique full images of a batch go to the device once; each ROI samples its
image by index.

Conventions (as in the reference):
  * scale = max(bw, bh) * dzi_pad_scale, clipped to max(im_H, im_W);
  * resize_ratio = out_res / scale;
  * roi_coord_2d is the [0, 1)-normalised full-image coordinate of each
    output pixel;
  * roi_cams stay the FULL-IMAGE intrinsics.
The training-time builder (online ground truth) arrives with training.
"""

from __future__ import annotations

import torch

from ..ops.crop import affine_grid_from_boxes, roi_crop_resize


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
