"""Visible Surface Discrepancy (VSD), batched on the tensors' device.

Port of ``gdrnpp_bop2022_tpu/eval/vsd.py`` (reference
lib/pysixd/pose_error.py:22-128, visibility.py:9-74, misc.py:628). Both
renders of a pair go through ``render`` (``ops/rasterizer.py::
render_depth_xyz``: kernel B2 in depth-only mode on the card, its plain
version on the CPU), and the per-tau cost cube of a whole batch is one
computation. Three paths:

  * ``vsd_batch`` renders a resampled window around the pair (crop-K
    centred on the union of the projected centres; the test depth is
    sampled nearest at the same window). Fast; approximate when the
    window clips the object or subsamples the pixel grid.
  * ``vsd_batch_bbox`` renders an image-grid window (principal point shifted
    by the integer window origin, no resampling) that ``vsd_bbox_plan``
    proves holds every pixel where either render is non-zero, so its counts
    equal the full-image ones. The scorer's ``vsd_mode="full"`` path.
  * ``vsd_batch_full`` renders the whole test image with the original K:
    the fallback for pairs no window bucket holds.

``vsd_dispatch`` picks the window path when it provably fits every pair,
the full image otherwise. The host planners are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.camera import centered_crop_K
from ..ops.crop import roi_crop_resize
from ..ops.rasterizer import render_depth_xyz


def depth_to_dist(depth, K):
    """Depth (Z) image -> distance-from-camera image (misc.py:628).
    depth (B, H, W), K (B, 3, 3)."""
    B, H, W = depth.shape
    us = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :]
    vs = torch.arange(H, dtype=torch.float32, device=depth.device)[None, :, None]
    x = (us - K[:, 0, 2][:, None, None]) / K[:, 0, 0][:, None, None]
    y = (vs - K[:, 1, 2][:, None, None]) / K[:, 1, 1][:, None, None]
    return depth * torch.sqrt(x * x + y * y + 1.0)


def _visib_mask_bop19(d_test, d_model, delta):
    return ((d_model - d_test <= delta) | (d_test == 0)) & (d_model > 0)


def _vsd_errors(d_test, d_est, d_gt, K, diameters, taus, delta):
    """BOP19 VSD with step cost, normalised by the diameter, from the test
    depth and both renders on one pixel grid with intrinsics K: (B, T)."""
    dist_test = depth_to_dist(d_test, K)
    dist_est = depth_to_dist(d_est, K)
    dist_gt = depth_to_dist(d_gt, K)
    visib_gt = _visib_mask_bop19(dist_test, dist_gt, delta)
    visib_est = _visib_mask_bop19(dist_test, dist_est, delta)
    visib_est = visib_est | (visib_gt & (dist_est > 0))
    inter = visib_gt & visib_est
    union_count = (visib_gt | visib_est).sum(dim=(1, 2))            # (B,)
    comp_count = union_count - inter.sum(dim=(1, 2))
    dists = (dist_gt - dist_est).abs() / diameters[:, None, None]
    taus = torch.as_tensor(taus, dtype=torch.float32, device=d_test.device)
    costs = (dists[None] >= taus[:, None, None, None]) & inter[None]  # (T, B, H, W)
    err = (costs.sum(dim=(2, 3)) + comp_count[None]) / union_count[None].clamp_min(1)
    err = torch.where(union_count[None] == 0, torch.ones_like(err), err)
    return err.T


def vsd_batch(R_est, t_est, R_gt, t_gt, depth_test, Ks, verts, faces, diameters, taus,
              delta: float = 0.015, res: int = 128, render=render_depth_xyz):
    """VSD on a resampled res x res window around each pair: (B, T).

    R (B, 3, 3), t (B, 3), depth_test (B, H, W) full test depth (m), Ks
    (B, 3, 3), verts (B, V, 3) / faces (B, F, 3) per-pair meshes,
    diameters (B,), taus (T,) tolerances as fractions of the diameter.
    """
    def proj_center(t, K):
        return (K[:, 0, 0] * t[:, 0] / t[:, 2] + K[:, 0, 2],
                K[:, 1, 1] * t[:, 1] / t[:, 2] + K[:, 1, 2])

    ue, ve = proj_center(t_est, Ks)
    ug, vg = proj_center(t_gt, Ks)
    # the window: the diameter projected at the nearer depth, padded, plus
    # the centres' separation
    z_near = torch.minimum(t_est[:, 2].abs(), t_gt[:, 2].abs())
    f = torch.maximum(Ks[:, 0, 0], Ks[:, 1, 1])
    proj_diam = f * diameters / z_near.clamp_min(1e-6)
    sep = torch.sqrt((ue - ug) ** 2 + (ve - vg) ** 2)
    scale = torch.clamp(proj_diam * 1.4 + sep, 32.0, 4.0 * float(depth_test.shape[1]))
    centers = torch.stack([(ue + ug) * 0.5, (ve + vg) * 0.5], dim=-1)

    crop_Ks = centered_crop_K(Ks, centers, scale, res)
    d_est, _ = render(verts, faces, R_est, t_est, crop_Ks, res, res, need_xyz=False)
    d_gt, _ = render(verts, faces, R_gt, t_gt, crop_Ks, res, res, need_xyz=False)
    d_test_w = roi_crop_resize(depth_test[..., None], centers, scale, res,
                               method="nearest")[..., 0]
    return _vsd_errors(d_test_w, d_est, d_gt, crop_Ks, diameters, taus, delta)


def vsd_batch_full(R_est, t_est, R_gt, t_gt, depth_test, Ks, verts, faces, diameters,
                   taus, delta: float = 0.015, render=render_depth_xyz):
    """Toolkit-exact BOP19 VSD: both renders at the full test-image
    resolution with the original K (pose_error.py:22-128). Returns (B, T)."""
    B, H, W = depth_test.shape
    d_est, _ = render(verts, faces, R_est, t_est, Ks, H, W, need_xyz=False)
    d_gt, _ = render(verts, faces, R_gt, t_gt, Ks, H, W, need_xyz=False)
    return _vsd_errors(depth_test, d_est, d_gt, Ks, diameters, taus, delta)


def vsd_batch_bbox(R_est, t_est, R_gt, t_gt, depth_win, offs, Ks, verts, faces,
                   diameters, taus, delta: float = 0.015, render=render_depth_xyz):
    """Toolkit-exact BOP19 VSD on per-pair image-grid windows: (B, T).

    depth_win (B, bh, bw) are slices of the test depth at offs (B, 2) int
    (y0, x0); Ks are the ORIGINAL intrinsics. The principal point is shifted
    by the window origin, so the window's pixels are image pixels; given
    windows from ``vsd_bbox_plan`` the counts, and so the errors, equal
    ``vsd_batch_full``'s up to projection rounding (the shifted principal
    point moves u by <= 1 ulp).
    """
    B, bh, bw = depth_win.shape
    offs_f = offs.to(torch.float32)
    Kw = Ks.clone()
    Kw[:, 0, 2] -= offs_f[:, 1]
    Kw[:, 1, 2] -= offs_f[:, 0]
    d_est, _ = render(verts, faces, R_est, t_est, Kw, bh, bw, need_xyz=False)
    d_gt, _ = render(verts, faces, R_gt, t_gt, Kw, bh, bw, need_xyz=False)
    return _vsd_errors(depth_win, d_est, d_gt, Kw, diameters, taus, delta)


def _sphere_pixel_bounds(t, Ks, radii):
    """Conservative pixel bounds of a radius-r sphere at centre t under
    perspective K. Returns (u0, u1, v0, v1, ok); ok=False when the sphere
    reaches the camera plane (z - r <= 0), where no finite bound exists.
    u in [u0, u1) / v in [v0, v1) holds every projected surface pixel:
    u = fx*x/z + cx is linear in x and monotone in z for fixed x, so its
    extremes over the AABB {|x-tx|<=r, |y-ty|<=r, z in [tz-r, tz+r]} are at
    corner combinations."""
    t = np.asarray(t, np.float64)
    Ks = np.asarray(Ks, np.float64)
    r = np.asarray(radii, np.float64)
    fx, fy = Ks[:, 0, 0], Ks[:, 1, 1]
    cx, cy = Ks[:, 0, 2], Ks[:, 1, 2]
    z_lo = t[:, 2] - r
    ok = z_lo > 1e-6
    z_lo_s = np.maximum(z_lo, 1e-6)
    z_hi = t[:, 2] + r

    def ext(f, c, tc):
        lo = np.full(len(t), np.inf)
        hi = np.full(len(t), -np.inf)
        for xc in (tc - r, tc + r):
            for zc in (z_lo_s, z_hi):
                u = f * xc / zc + c
                lo = np.minimum(lo, u)
                hi = np.maximum(hi, u)
        return lo, hi

    u0, u1 = ext(fx, cx, t[:, 0])
    v0, v1 = ext(fy, cy, t[:, 1])
    return u0, u1, v0, v1, ok


def vsd_bbox_plan(t_est, t_gt, Ks, radii, im_h: int, im_w: int, sizes=(128, 256, 512)):
    """Host-side plan for vsd_batch_bbox: per pair, the smallest window
    bucket holding the union of the two conservative sphere-projection
    boxes (clipped to the image), and the window origin.

    Returns (bucket (B,) int32 index into the returned bucket list, -1 =
    no bucket fits (use vsd_batch_full); offs (B, 2) int32 (y0, x0);
    buckets: list of (bh, bw) with bh<=im_h, bw<=im_w)."""
    buckets = []
    for s in sizes:
        b = (min(s, im_h), min(s, im_w))
        if b not in buckets and (b[0] < im_h or b[1] < im_w):
            buckets.append(b)

    ue0, ue1, ve0, ve1, oke = _sphere_pixel_bounds(t_est, Ks, radii)
    ug0, ug1, vg0, vg1, okg = _sphere_pixel_bounds(t_gt, Ks, radii)
    # union box, expanded 1px against rounding, clipped to the image
    u0 = np.clip(np.floor(np.minimum(ue0, ug0)) - 1, 0, im_w)
    v0 = np.clip(np.floor(np.minimum(ve0, vg0)) - 1, 0, im_h)
    u1 = np.clip(np.ceil(np.maximum(ue1, ug1)) + 2, 0, im_w)
    v1 = np.clip(np.ceil(np.maximum(ve1, vg1)) + 2, 0, im_h)
    need_w = np.maximum(u1 - u0, 1).astype(np.int64)
    need_h = np.maximum(v1 - v0, 1).astype(np.int64)
    ok = oke & okg

    B = len(need_w)
    bucket = np.full(B, -1, np.int32)
    offs = np.zeros((B, 2), np.int32)
    for bi in reversed(range(len(buckets))):
        bh, bw = buckets[bi]
        fits = ok & (need_h <= bh) & (need_w <= bw)
        bucket[fits] = bi
    for bi, (bh, bw) in enumerate(buckets):
        m = bucket == bi
        if not m.any():
            continue
        # centre the slack, clamp inside the image
        y0 = np.clip(v0[m] - (bh - need_h[m]) // 2, 0, im_h - bh)
        x0 = np.clip(u0[m] - (bw - need_w[m]) // 2, 0, im_w - bw)
        offs[m, 0] = y0
        offs[m, 1] = x0
    return bucket, offs, buckets


def window_fits(R_est, t_est, R_gt, t_gt, Ks, diameters, im_h: int, im_w: int,
                res: int = 128, margin: float = 1.1) -> np.ndarray:
    """Host-side check (numpy) whether vsd_batch's window provably holds
    both projected objects: conservative bounding-sphere projection at the
    nearest surface depth vs the window the same formula would pick.
    Returns (B,) bool."""
    t_est, t_gt = np.asarray(t_est), np.asarray(t_gt)
    Ks = np.asarray(Ks)
    diameters = np.asarray(diameters)
    f = np.maximum(Ks[:, 0, 0], Ks[:, 1, 1])

    def bounds(t):
        z = np.abs(t[:, 2])
        z_near = np.maximum(z - diameters / 2.0, 1e-6)
        u = Ks[:, 0, 0] * t[:, 0] / t[:, 2] + Ks[:, 0, 2]
        v = Ks[:, 1, 1] * t[:, 1] / t[:, 2] + Ks[:, 1, 2]
        r = f * (diameters / 2.0) / z_near
        return u, v, r

    ue, ve, re_ = bounds(t_est)
    ug, vg, rg = bounds(t_gt)
    cx = (ue + ug) * 0.5
    cy = (ve + vg) * 0.5
    need = 2.0 * np.maximum(
        np.maximum(np.abs(ue - cx) + re_, np.abs(ug - cx) + rg),
        np.maximum(np.abs(ve - cy) + re_, np.abs(vg - cy) + rg)) * margin
    # the window vsd_batch will use (keep in step with it)
    z_near = np.minimum(np.abs(t_est[:, 2]), np.abs(t_gt[:, 2]))
    proj_diam = f * diameters / np.maximum(z_near, 1e-6)
    sep = np.sqrt((ue - ug) ** 2 + (ve - vg) ** 2)
    scale = np.clip(proj_diam * 1.4 + sep, 32.0, 4.0 * float(im_h))
    # and the window grid must not subsample the image grid too far
    return (need <= scale) & (scale <= 2.0 * res)


def vsd_dispatch(R_est, t_est, R_gt, t_gt, depth_test, Ks, verts, faces, diameters, taus,
                 delta: float = 0.015, res: int = 128, mode: str = "auto",
                 render=render_depth_xyz):
    """Windowed VSD when the window provably fits every pair of the batch,
    toolkit-exact full-image VSD otherwise. mode: "auto" | "window" | "full"."""
    if mode not in ("auto", "window", "full"):
        raise ValueError(f"vsd mode {mode!r}: auto | window | full")
    args = (R_est, t_est, R_gt, t_gt, depth_test, Ks, verts, faces, diameters, taus, delta)
    if mode == "window":
        return vsd_batch(*args, res=res, render=render)
    host = lambda a: a.detach().cpu().numpy()       # noqa: E731
    if mode == "full" or not bool(np.all(window_fits(
            host(R_est), host(t_est), host(R_gt), host(t_gt), host(Ks), host(diameters),
            depth_test.shape[1], depth_test.shape[2], res=res))):
        return vsd_batch_full(*args, render=render)
    return vsd_batch(*args, res=res, render=render)
