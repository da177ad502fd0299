"""GDRNPP's depth refinement (BOP'22 RGB-D), with a plain z-buffer rasterizer.

The rasterizer renders depth at integer pixel centres: a pixel is inside a
face when its three edge-function barycentrics are at least -1e-5, the face
has a nonzero screen area and every vertex lies in front of the camera; its
depth is perspective-correct, 1 / sum(w_i / z_i); the nearest face wins;
pixels that no face covers read 0. The refinement is GDRNPP's
``process_depth_refine``: per iteration, render the mesh at the current
pose, weight each pixel that is both rendered and sensed by |xyz| times the
mask probability, take the median depth difference over the pixels above
``threshold`` of the peak weight, and move t along the weighted mean ray.
"""

from __future__ import annotations

import torch

from .geometry import crop_K

EDGE_EPS = -1e-5
BLOCK = 1 << 24        # (ROIs x pixels x faces) elements live at once


def render_depth(verts, faces, R, t, K, res: int) -> torch.Tensor:
    """verts (B, V, 3), faces (B, F, 3), pose R (B, 3, 3), t (B, 3), K (B, 3, 3)
    -> depth (B, res, res)."""
    B, F = faces.shape[:2]
    cam = torch.einsum("bij,bvj->bvi", R, verts) + t[:, None, :]
    z = cam[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[:, 0, 0, None] * cam[..., 0] / zs + K[:, 0, 1, None] * cam[..., 1] / zs + K[:, 0, 2, None]
    v = K[:, 1, 1, None] * cam[..., 1] / zs + K[:, 1, 2, None]
    f = faces.long()
    pick = lambda a, k: torch.gather(a, 1, f[..., k])       # noqa: E731
    x0, x1, x2 = (pick(u, k) for k in range(3))
    y0, y1, y2 = (pick(v, k) for k in range(3))
    z0, z1, z2 = (pick(z, k) for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    ok = (area.abs() > 1e-12) & (z0 > 1e-6) & (z1 > 1e-6) & (z2 > 1e-6)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                           torch.zeros_like(area))
    iz = [1.0 / torch.where(zk > 1e-6, zk, torch.ones_like(zk)) for zk in (z0, z1, z2)]
    pix = torch.arange(res * res, device=verts.device)
    px = (pix % res).float()[None, :, None]
    py = torch.div(pix, res, rounding_mode="floor").float()[None, :, None]
    depth = torch.full((B, res * res), float("inf"), device=verts.device)
    fc = max(1, min(F, BLOCK // (res * res)))
    for b in range(B):
        for f0 in range(0, F, fc):
            s = slice(f0, f0 + fc)
            sel = lambda a: a[b:b + 1, None, s]              # noqa: E731
            w0 = ((sel(x1) - px) * (sel(y2) - py) - (sel(x2) - px) * (sel(y1) - py)) * sel(inv_area)
            w1 = ((sel(x2) - px) * (sel(y0) - py) - (sel(x0) - px) * (sel(y2) - py)) * sel(inv_area)
            w2 = 1.0 - w0 - w1
            inside = (w0 >= EDGE_EPS) & (w1 >= EDGE_EPS) & (w2 >= EDGE_EPS) & sel(ok)
            zp = 1.0 / (w0 * sel(iz[0]) + w1 * sel(iz[1]) + w2 * sel(iz[2])).clamp_min(1e-12)
            zp = torch.where(inside & (zp > 1e-6), zp, torch.full_like(zp, float("inf")))
            depth[b] = torch.minimum(depth[b], zp.amin(dim=-1)[0])
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    return depth.reshape(B, res, res)


def mask_prob_l1(vis: torch.Tensor) -> torch.Tensor:
    """An L1-trained visible mask (B, H, W) -> [0, 1] by its per-ROI min and max."""
    mx = vis.amax(dim=(1, 2), keepdim=True)
    mn = vis.amin(dim=(1, 2), keepdim=True)
    return (vis - mn) / (mx - mn).clamp_min(1e-12)


def depth_refine(R, t, mask_prob, coor, depth_sensor, Ks, centers, scales, verts, faces,
                 extents, iters: int, threshold: float, res: int) -> torch.Tensor:
    """-> refined t (B, 3). coor (B, 3, H, W) in [0, 1], depth_sensor (B, H, W)."""
    B, H, W = mask_prob.shape
    K = crop_K(Ks, centers, scales, res)
    xyz = (coor.permute(0, 2, 3, 1) - 0.5) * extents[:, None, None, :]
    base = torch.linalg.vector_norm(xyz, dim=-1) * mask_prob
    sensed = depth_sensor > 0
    ys = torch.arange(H, dtype=torch.float32, device=R.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=R.device)[None, None, :]
    for _ in range(iters):
        ren = render_depth(verts, faces, R, t, K, res)
        q = base * (ren > 0) * sensed
        qsum = q.sum(dim=(1, 2), keepdim=True)
        qn = q / qsum.clamp_min(1e-12)
        support = qn > qn.amax(dim=(1, 2), keepdim=True) * threshold
        diff = torch.where(support, depth_sensor - ren, torch.full_like(ren, 1e6))
        n = support.sum(dim=(1, 2))
        med = torch.sort(diff.reshape(B, -1), dim=1).values.gather(1, (n // 2)[:, None])[:, 0]
        med = torch.where(n > 0, med, torch.zeros_like(med))
        rx = ((xs * qn).sum(dim=(1, 2)) - K[:, 0, 2]) / K[:, 0, 0]
        ry = ((ys * qn).sum(dim=(1, 2)) - K[:, 1, 2]) / K[:, 1, 1]
        ray = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
        ok = (qsum[:, 0, 0] > 0) & (n > 0)
        t = t + torch.where(ok[:, None], ray * med[:, None], torch.zeros_like(ray))
    return t
