"""ROI crops, the SITE pose decode and crop intrinsics, in fp32.

Conventions of GDRNPP's test path: a detection box (x1, y1, x2, y2) gives
the centre of the box and the scale max(w, h) * 1.5 (clipped to the image's
longer side); output pixel (i, j) of an ROI of side ``res`` samples the image
at centre + (j - res / 2) * scale / res (rows likewise), with integer pixel
centres and zeros outside the image (cv2.warpAffine's bilinear convention).
The allocentric-to-egocentric correction and the 6D rotation follow
GDRNPP's ``allo_to_ego_mat_torch`` and ``rot6d_to_mat_batch``, their
epsilons included.
"""

from __future__ import annotations

import torch

DZI_PAD_SCALE = 1.5


def boxes_to_centers_scales(boxes: torch.Tensor, im_h: int, im_w: int):
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = (x2 - x1).clamp_min(1.0)
    bh = (y2 - y1).clamp_min(1.0)
    centers = torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5], dim=-1)
    scales = (torch.maximum(bw, bh) * DZI_PAD_SCALE).clamp_max(float(max(im_h, im_w)))
    return centers, scales, torch.stack([bw, bh], dim=-1)


def sample_grid(centers: torch.Tensor, scales: torch.Tensor, res: int):
    """Source x (B, res) along a row and y (B, res) down a column."""
    off = torch.arange(res, dtype=torch.float32, device=centers.device) - res * 0.5
    step = scales[:, None] / res
    return centers[:, 0:1] + off * step, centers[:, 1:2] + off * step


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); yi (R, 1), xi (1, R) int -> (R, R, C), zero outside."""
    H, W = img.shape[:2]
    inside = ((yi >= 0) & (yi < H)) & ((xi >= 0) & (xi < W))
    v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)].float()
    return v * inside[..., None]


def crop_bilinear(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """One ROI: img (H, W, C), sample positions cx (R,), cy (R,) -> (R, R, C)."""
    x0, y0 = torch.floor(cx), torch.floor(cy)
    wx = (cx - x0)[None, :, None]
    wy = (cy - y0)[:, None, None]
    xi, yi = x0.long()[None, :], y0.long()[:, None]
    top = _gather(img, yi, xi) * (1 - wx) + _gather(img, yi, xi + 1) * wx
    bot = _gather(img, yi + 1, xi) * (1 - wx) + _gather(img, yi + 1, xi + 1) * wx
    return top * (1 - wy) + bot * wy


def crop_nearest(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Nearest sample (round half to even) of img (H, W, C) -> (R, R, C)."""
    return _gather(img, torch.round(cy).long()[:, None], torch.round(cx).long()[None, :])


def roi_inputs(images, depths, img_idx, boxes, Ks, input_res: int, output_res: int,
               pixel_mean, pixel_std, bp_depth: bool):
    """Per ROI: the normalised RGB crop (B, in, in, 3), the absolute 2D
    coordinates (B, out, out, 2), the backprojected depth crop (B, in, in,
    3) or None, the sensor depth at out_res (B, out, out) or None, and the
    box parameters."""
    im_h, im_w = images.shape[1:3]
    centers, scales, whs = boxes_to_centers_scales(boxes, im_h, im_w)
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=images.device)
    rgb, coord, dep_in, dep_out = [], [], [], []
    wh = torch.tensor([im_w, im_h], dtype=torch.float32, device=images.device)
    for i in range(boxes.shape[0]):
        img = images[img_idx[i]]
        cx, cy = (g[i] for g in sample_grid(centers, scales, input_res))
        rgb.append((crop_bilinear(img, cx, cy) - mean) / std)
        ox, oy = (g[i] for g in sample_grid(centers, scales, output_res))
        grid = torch.stack(torch.broadcast_tensors(ox[None, :], oy[:, None]), dim=-1)
        coord.append(grid / wh)
        if depths is not None:
            d = depths[img_idx[i]][..., None]
            din = crop_nearest(d, cx, cy)[..., 0]
            if bp_depth:
                K = Ks[i]
                xs, ys = torch.round(cx)[None, :], torch.round(cy)[:, None]
                X = (xs - K[0, 2]) / K[0, 0] * din
                Y = (ys - K[1, 2]) / K[1, 1] * din
                din = torch.stack([X, Y, din], dim=-1)
            else:
                din = din[..., None]
            dep_in.append(din)
            dep_out.append(crop_nearest(d, ox, oy)[..., 0])
    stack = lambda xs: torch.stack(xs) if xs else None   # noqa: E731
    return {"roi_img": stack(rgb), "roi_coord_2d": stack(coord), "roi_depth": stack(dep_in),
            "depth_out": stack(dep_out), "centers": centers, "scales": scales, "whs": whs}


def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def rot6d_to_mat(d6: torch.Tensor) -> torch.Tensor:
    """The two 3-vectors Gram-Schmidt orthonormalised into R's first two columns."""
    x = normalize(d6[..., 0:3])
    z = normalize(torch.linalg.cross(x, d6[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    s = 2.0 / (q * q).sum(-1).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - (y * y + z * z) * s, (x * y - w * z) * s, (x * z + w * y) * s,
        (x * y + w * z) * s, 1 - (x * x + z * z) * s, (y * z - w * x) * s,
        (x * z - w * y) * s, (y * z + w * x) * s, 1 - (x * x + y * y) * s], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def allo_to_ego(t: torch.Tensor, rot_allo: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotate the optical axis onto the object's ray, then apply rot_allo."""
    ray = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + eps)
    angle = torch.arccos(ray[:, 2].clamp(-1 + 1e-7, 1 - 1e-7))
    axis = torch.stack([-ray[:, 1], ray[:, 0], torch.zeros_like(angle)], dim=-1)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + eps)
    q = torch.cat([torch.cos(angle / 2)[:, None], axis * torch.sin(angle / 2)[:, None]], -1)
    return quat_to_mat(q) @ rot_allo


def site_decode(rot_allo, t_pred, Ks, centers, whs, resize_ratios):
    """(allocentric R, (dx, dy, z_rel)) -> (egocentric R, t) with relative z."""
    cx = t_pred[:, 0] * whs[:, 0] + centers[:, 0]
    cy = t_pred[:, 1] * whs[:, 1] + centers[:, 1]
    z = t_pred[:, 2] * resize_ratios
    t = torch.stack([z * (cx - Ks[:, 0, 2]) / Ks[:, 0, 0],
                     z * (cy - Ks[:, 1, 2]) / Ks[:, 1, 1], z], dim=-1)
    return allo_to_ego(t, rot_allo), t


def crop_K(Ks, centers, scales, res: int):
    """Intrinsics of the square crop of side ``scales`` at ``centers``, resized to res."""
    x1 = centers[:, 0] - scales * 0.5
    y1 = centers[:, 1] - scales * 0.5
    s = res / scales
    K = torch.zeros_like(Ks)
    K[:, 0, 0] = Ks[:, 0, 0] * s
    K[:, 0, 1] = Ks[:, 0, 1] * s
    K[:, 0, 2] = (Ks[:, 0, 2] - x1) * s
    K[:, 1, 1] = Ks[:, 1, 1] * s
    K[:, 1, 2] = (Ks[:, 1, 2] - y1) * s
    K[:, 2, 2] = 1.0
    return K
