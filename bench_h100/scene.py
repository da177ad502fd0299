"""Synthetic test frames: ellipsoid objects under a dataset's camera, analytic depth.

Rewritten from ``chip_smoke.py``'s scene builders (``ellipsoid_mesh``,
``pixel_rays``, ``ellipsoid_hits``, ``random_rotation``) to draw every frame
in bulk on the device from one ``torch.Generator``. Each object is an
ellipsoid of its class's semi-axes; a frame's depth is the nearest
ray-ellipsoid hit at each pixel centre (meters, 0 where nothing is hit), its
colour a shade per class over a gradient with noise, and each object's
detection is the box of its whole silhouette clipped to the image
(``AMODAL_CLIP``), jittered by a few pixels, with a score.
"""

from __future__ import annotations

import numpy as np
import torch


def ellipsoid_mesh(axes: np.ndarray, lat: int, lon: int):
    """UV-tessellated ellipsoid of semi-axes ``axes`` (3,): 2 + (lat - 1) * lon
    vertices, 2 * lon * (lat - 1) faces, outward winding."""
    th = np.linspace(0, np.pi, lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)), np.outer(np.sin(th), np.sin(ph)),
                     np.repeat(np.cos(th)[:, None], lon, 1)], -1).reshape(-1, 3)
    pts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * np.asarray(axes)
    faces = []
    for j in range(lon):
        k = (j + 1) % lon
        faces.append([0, 1 + j, 1 + k])
        for i in range(lat - 2):
            a, b = 1 + i * lon + j, 1 + i * lon + k
            faces += [[a, a + lon, b + lon], [a, b + lon, b]]
        last = 1 + (lat - 2) * lon
        faces.append([last + j, len(pts) - 1, last + k])
    return pts, np.asarray(faces)


def mesh_bank(axes: np.ndarray, lat: int, lon: int):
    """Meshes of every class: verts (C, V, 3) float32, faces (C, F, 3) int32."""
    meshes = [ellipsoid_mesh(a, lat, lon) for a in axes]
    return (np.stack([m[0] for m in meshes]).astype(np.float32),
            np.stack([m[1] for m in meshes]).astype(np.int32))


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        -1).reshape(-1, 3, 3)


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)


def make_frames(gen: torch.Generator, counts, scene: dict, axes: np.ndarray, device):
    """Frames with counts[f] objects of distinct classes each.

    scene: the configuration's ``scene`` block (``width``, ``height``, ``K``,
    ``z_m``, ``margin_px``, ``box_jitter_px``, ``score``). axes (C, 3): the
    classes' semi-axes in meters. Returns host arrays images (N, H, W, 3)
    uint8 and depths (N, H, W) float32, and per frame a list of detections
    {label, obj_id, score, bbox_xyxy (4,) float32}."""
    H, W = scene["height"], scene["width"]
    K = torch.tensor(scene["K"], dtype=torch.float64, device=device)
    C, N, F = len(axes), int(sum(counts)), len(counts)
    nmax = max(counts)
    if nmax > C:
        raise ValueError(f"{nmax} objects a frame, but only {C} classes")
    # every draw at once: classes, rotations, depths, image positions, jitter, scores, noise
    classes = torch.rand((F, C), generator=gen, device=device).argsort(dim=1)[:, :nmax]
    quats = torch.randn((N, 4), generator=gen, device=device, dtype=torch.float64)
    z = _uniform(gen, (N,), *scene["z_m"], device)
    m = scene["margin_px"]
    u = _uniform(gen, (N,), m, W - m, device)
    v = _uniform(gen, (N,), m, H - m, device)
    jit = _uniform(gen, (N, 2), -scene["box_jitter_px"], scene["box_jitter_px"], device)
    score = _uniform(gen, (N,), *scene["score"], device)
    noise = torch.randint(0, 30, (F, H, W, 3), generator=gen, device=device, dtype=torch.uint8)

    lab = torch.cat([classes[f, :n] for f, n in enumerate(counts)])
    R = _quat_to_mat(quats)
    ax = torch.as_tensor(axes, dtype=torch.float64, device=device)[lab]
    y_ray = (v - K[1, 2]) / K[1, 1]
    x_ray = (u - K[0, 2] - K[0, 1] * y_ray) / K[0, 0]
    t = z[:, None] * torch.stack([x_ray, y_ray, torch.ones_like(z)], -1)

    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float64),
                            torch.arange(W, device=device, dtype=torch.float64), indexing="ij")
    ry = (ys - K[1, 2]) / K[1, 1]
    rays = torch.stack([(xs - K[0, 2] - K[0, 1] * ry) / K[0, 0], ry, torch.ones_like(ry)],
                       -1).reshape(-1, 3)                              # (P, 3), z = 1
    depths = torch.zeros((F, H * W), dtype=torch.float64, device=device)
    shade = torch.zeros((F, H * W), dtype=torch.float64, device=device)
    boxes = torch.zeros((N, 4), dtype=torch.float64, device=device)
    o = 0
    for f, n in enumerate(counts):
        sl = slice(o, o + n)
        # ray s * d meets the ellipsoid |A^-1 R^T (s d - t)| = 1 at the smaller root
        mo = rays @ R[sl] / ax[sl][:, None, :]                         # (n, P, 3)
        no = (torch.einsum("nji,nj->ni", R[sl], t[sl]) / ax[sl])[:, None, :]
        a = (mo * mo).sum(-1)
        b = -2.0 * (mo * no).sum(-1)
        c = (no * no).sum(-1) - 1.0
        disc = b * b - 4 * a * c
        s = (-b - disc.clamp_min(0).sqrt()) / (2 * a)
        hit = (disc >= 0) & (s > 0)
        d = torch.where(hit, s, torch.full_like(s, float("inf")))
        near, owner = d.min(dim=0)
        seen = torch.isfinite(near)
        depths[f] = torch.where(seen, near, torch.zeros_like(near))
        shade[f] = torch.where(seen, 60.0 + 9.0 * (lab[sl][owner] + 1).double(),
                               torch.zeros_like(near))
        hm = hit.reshape(n, H, W)
        cols, rows = hm.any(dim=1), hm.any(dim=2)
        idx_w = torch.arange(W, device=device, dtype=torch.float64)
        idx_h = torch.arange(H, device=device, dtype=torch.float64)
        x0 = torch.where(cols, idx_w, torch.full_like(idx_w, W)).amin(1)
        x1 = torch.where(cols, idx_w, torch.full_like(idx_w, -1)).amax(1)
        y0 = torch.where(rows, idx_h, torch.full_like(idx_h, H)).amin(1)
        y1 = torch.where(rows, idx_h, torch.full_like(idx_h, -1)).amax(1)
        bx, by = x0 + jit[sl, 0], y0 + jit[sl, 1]
        boxes[sl] = torch.stack([bx, by, bx + x1 - x0 + 1, by + y1 - y0 + 1], -1)
        o += n
    if not bool(torch.isfinite(boxes).all()) or bool((boxes[:, 2] <= boxes[:, 0]).any()):
        raise RuntimeError("an object of a frame is out of view")
    xx = xs.reshape(1, -1)
    yy = ys.reshape(1, -1)
    img = torch.stack([shade + xx * 0.1, shade * 0.8 + yy * 0.1, shade * 0.6], -1)
    img = (img.reshape(F, H, W, 3) + noise.double()) % 256

    images = img.to(torch.uint8).cpu().numpy()
    depths = depths.reshape(F, H, W).float().cpu().numpy()
    lab_h, score_h, boxes_h = lab.cpu().numpy(), score.cpu().numpy(), boxes.float().cpu().numpy()
    dets, o = [], 0
    for n in counts:
        dets.append([{"label": int(lab_h[i]), "obj_id": int(lab_h[i]) + 1,
                      "score": float(score_h[i]), "bbox_xyxy": boxes_h[i]}
                     for i in range(o, o + n)])
        o += n
    return images, depths, dets
