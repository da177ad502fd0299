"""Batched z-buffer rasterizer: kernel B2's wrapper, its face packing and its cull rule.

``render_depth_xyz_cuda`` is the port of
``gdrnpp_bop2022_tpu/ops/pallas_raster.py::render_depth_xyz_pallas``: it
renders depth (B, H, W) and, with ``need_xyz``, object-space XYZ
(B, H, W, 3) of B posed meshes through the hand-written kernels of
``csrc/raster.cu`` (built with nvcc at first use, without FMA
contraction), in two launches: ``pack_faces_cuda`` packs the faces on the
card, then the tiled raster kernel culls them per 32x8 pixel tile and
rasterizes. It takes CUDA tensors only and raises on anything else; the
dispatcher ``ops.rasterizer.render_depth_xyz`` sends CPU tensors to the
plain version. ``render_depth_xyz_cuda.launches`` counts raster launches,
``pack_faces_cuda.launches`` pack launches.

``_pack_face_data`` is the plain version's per-face preparation, as torch
gathers (in the JAX package it is XLA outside the Pallas kernel):
projection with each ROI's K (skew included), then per face x/y of its 3
vertices, their 1/z, a validity flag and 1/area, plus the 9 attribute
values in attribute mode, as rows of (B, 20|11, F). The pack kernel
computes the same values in the same operation order, face-major
(``face_major`` states the layout), so the two agree bit for bit.
``face_screen_boxes`` states the cull rule that the pack kernel computes.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_ROIS = 65535       # grid.y of the raster launch
_MAX_SIDE = 65536       # the raster kernel keeps a box's bounds in 16 bits
# floats per packed face (face-major): 11 rows + 1 pad; with the 9
# attribute values, + 3 pad, so a face is 3 (6) float4
PACKED_COLS = {False: 12, True: 24}
# the screen box's margin: BOX_MARGIN_PX + BOX_MARGIN_REL x (width + height)
BOX_MARGIN_PX = 1.0
BOX_MARGIN_REL = 1e-4
BOX_MAX_EXTENT = float(1 << 20)   # px; beyond it (or non-finite) a face gets the whole image
BOX_ROUNDING = 2.0 ** -18         # LAMBDA of face_screen_boxes: 64 x fp32's unit roundoff
BOX_EPS = 2.0 ** -15              # > 2e-5: the seam tolerance 1e-5 with slack, exact in fp32
_lib = None


def transform_verts(verts: torch.Tensor, rots: torch.Tensor,
                    transes: torch.Tensor) -> torch.Tensor:
    """Object-space verts (B, V, 3) -> camera space R v + t, written out
    elementwise so the card and the CPU round every product alike."""
    return (rots[:, None, :, 0] * verts[..., 0:1] + rots[:, None, :, 1] * verts[..., 1:2]
            + rots[:, None, :, 2] * verts[..., 2:3]) + transes[:, None, :]


def _pack_face_data(verts_cam: torch.Tensor, attrs: torch.Tensor, faces: torch.Tensor,
                    K: torch.Tensor, with_attrs: bool = True) -> torch.Tensor:
    """Per-face data, one row per quantity: (B, 20, F), or (B, 11, F)
    without the attribute rows. Invalid faces (zero area, or a vertex at
    z <= 1e-6, as the bank's (0, 0, 0) padding faces) get valid 0 and
    inv_area 0, so they never win the depth test."""
    z = verts_cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = (K[:, 0, 0, None] * verts_cam[..., 0] / safe_z + K[:, 0, 2, None]
         + K[:, 0, 1, None] * verts_cam[..., 1] / safe_z)
    v = K[:, 1, 1, None] * verts_cam[..., 1] / safe_z + K[:, 1, 2, None]
    inv_z = 1.0 / safe_z
    faces = faces.long()
    i0, i1, i2 = faces[..., 0], faces[..., 1], faces[..., 2]

    def g(arr, idx):
        return torch.gather(arr, 1, idx)

    x0, x1, x2 = g(u, i0), g(u, i1), g(u, i2)
    y0, y1, y2 = g(v, i0), g(v, i1), g(v, i2)
    z0, z1, z2 = g(z, i0), g(z, i1), g(z, i2)
    iz0, iz1, iz2 = g(inv_z, i0), g(inv_z, i1), g(inv_z, i2)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = ((area.abs() > 1e-12) & (z0 > 1e-6) & (z1 > 1e-6)
             & (z2 > 1e-6)).float()
    inv_area = torch.where(valid > 0.5,
                           1.0 / torch.where(area.abs() < 1e-12, torch.ones_like(area), area),
                           torch.zeros_like(area))
    rows = [x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, valid, inv_area]
    if with_attrs:
        rows += [g(attrs[..., c], i) for i in (i0, i1, i2) for c in range(3)]
    return torch.stack(rows, dim=1)


def face_major(fd: torch.Tensor) -> torch.Tensor:
    """The pack kernel's layout of ``_pack_face_data``'s rows (B, 11|20, F):
    (B, F, 12|24), rows 0-10 in columns 0-10, the attribute rows 11-19 in
    columns 12-20, zeros elsewhere."""
    B, n_rows, F = fd.shape
    out = fd.new_zeros((B, F, PACKED_COLS[n_rows == 20]))
    out[..., :11] = fd[:, :11].transpose(1, 2)
    out[..., 12:12 + n_rows - 11] = fd[:, 11:].transpose(1, 2)
    return out


def face_screen_boxes(fd: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The cull rule: per face of ``_pack_face_data``'s rows (B, 11|20, F),
    the inclusive box [x_lo, y_lo, x_hi, y_hi] (B, F, 4) int32 of the pixel
    centres of an height x width image at which the plain version's inside
    test can accept the face. The pack kernel computes the same boxes.

    With S = box width + height, a pixel centre that passes the inside test
    in exact arithmetic (every barycentric >= -1e-5) lies at most 3e-5 S
    outside the face's box; one at distance d outside has a barycentric
    <= -d / (3 S). The box is widened by m = 1 + 1e-4 S px, floored and
    ceiled to pixel centres and clamped to the image. Rounding moves a
    computed barycentric by at most ~30 u (S + d)^2 / |area| (u = 2^-24), so
    the margin holds where that stays below d / (3 S) for every d from m to
    Q, the farthest a pixel of the image can be from the face's vertices;
    the bound is concave in d, so its two ends are checked, with
    LAMBDA = 2^-18 = 64 u. A face that fails that test (a sliver: the
    adversarial tests find ones whose rounding accepts pixels tens of px
    away), has a non-finite coordinate, or spans more than 2^20 px (a
    vertex near the z = 1e-6 plane) gets the whole image; an invalid face
    the empty box (0, 0, -1, -1)."""
    xs, ys = fd[:, 0:6:2], fd[:, 1:6:2]
    x0, x1, x2 = xs.unbind(1)
    y0, y1, y2 = ys.unbind(1)
    xmin, xmax = torch.minimum(torch.minimum(x0, x1), x2), torch.maximum(torch.maximum(x0, x1), x2)
    ymin, ymax = torch.minimum(torch.minimum(y0, y1), y2), torch.maximum(torch.maximum(y0, y1), y2)
    bw, bh = xmax - xmin, ymax - ymin
    S = bw + bh
    m = BOX_MARGIN_PX + BOX_MARGIN_REL * S
    lam = BOX_ROUNDING * fd[:, 10].abs()
    Q = torch.maximum(torch.maximum(torch.maximum(xmax, (width - 1) - xmin), ymax),
                      (height - 1) - ymin)
    sm, sq = S + m, S + Q
    conditioned = ((lam * (S * S) < 0.125) & (m > 3.0 * S * (lam * (sm * sm) + BOX_EPS))
                   & (Q > 3.0 * S * (lam * (sq * sq) + BOX_EPS)))
    lx = torch.clamp(torch.floor(xmin - m), 0, width)
    hx = torch.clamp(torch.ceil(xmax + m), -1, width - 1)
    ly = torch.clamp(torch.floor(ymin - m), 0, height)
    hy = torch.clamp(torch.ceil(ymax + m), -1, height - 1)
    box = torch.stack([lx, ly, hx, hy], -1)
    whole = (~(torch.isfinite(xs).all(1) & torch.isfinite(ys).all(1))
             | ~(bw <= BOX_MAX_EXTENT) | ~(bh <= BOX_MAX_EXTENT) | ~conditioned)
    box = torch.where(whole[..., None], box.new_tensor([0, 0, width - 1, height - 1]), box)
    empty = (fd[:, 9] <= 0.5) | ((box[..., 0] > box[..., 2]) | (box[..., 1] > box[..., 3]))
    box = torch.where(empty[..., None], box.new_tensor([0, 0, -1, -1]), box)
    return box.to(torch.int32)


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..utils.cuda_build import load_kernel_library
        lib = load_kernel_library("raster")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdrn_raster_pack.argtypes = [p, p, i, p, p, p, i, i, i, i, i, i, p, p, p]
        lib.gdrn_raster_fwd.argtypes = [p, p, i, i, i, i, p, p, i, p]
        lib.gdrn_raster_pack.restype = lib.gdrn_raster_fwd.restype = i
        _lib = lib
    return _lib


def _check_cuda_args(verts, faces, rots, transes, Ks, height, width):
    if verts.device.type != "cuda":
        raise ValueError(f"raster kernel takes CUDA tensors, got {verts.device}")
    B = verts.shape[0]
    for name, t, shape in (("verts", verts, (B, verts.shape[1], 3)),
                           ("rots", rots, (B, 3, 3)), ("transes", transes, (B, 3)),
                           ("Ks", Ks, (B, 3, 3))):
        if t.device != verts.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"raster kernel: {name} must be float32 {shape} on "
                             f"{verts.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (faces.device != verts.device or faces.dtype not in (torch.int32, torch.int64)
            or faces.dim() != 3 or faces.shape[0] != B or faces.shape[2] != 3):
        raise ValueError(f"raster kernel: faces must be int (B, F, 3) on {verts.device}, "
                         f"got {faces.dtype} {tuple(faces.shape)} on {faces.device}")
    if B > _MAX_ROIS:
        raise ValueError(f"raster kernel takes at most {_MAX_ROIS} ROIs per call, got {B}")
    if max(height, width) > _MAX_SIDE:
        raise ValueError(f"raster kernel takes images of at most {_MAX_SIDE} px a side, "
                         f"got {height} x {width}")
    if torch.is_grad_enabled() and verts.requires_grad:
        raise NotImplementedError("raster kernel is forward-only")


def pack_faces_cuda(verts, faces, rots, transes, Ks, height: int, width: int,
                    with_attrs: bool = True):
    """B2's face packing on the card in one launch: (packed (B, F, 12|24)
    float32, equal to ``face_major(_pack_face_data(...))``; boxes (B, F, 4)
    int32, equal to ``face_screen_boxes``). A face with a vertex index
    outside [0, V) is packed as invalid."""
    _check_cuda_args(verts, faces, rots, transes, Ks, height, width)
    B, V, F = verts.shape[0], verts.shape[1], faces.shape[1]
    dev = verts.device
    packed = torch.empty((B, F, PACKED_COLS[with_attrs]), dtype=torch.float32, device=dev)
    boxes = torch.empty((B, F, 4), dtype=torch.int32, device=dev)
    if B * F == 0:
        return packed, boxes
    verts, faces, rots, transes, Ks = (t.contiguous() for t in (verts, faces, rots, transes, Ks))
    with torch.cuda.device(dev):
        err = _kernels().gdrn_raster_pack(
            verts.data_ptr(), faces.data_ptr(), int(faces.dtype == torch.int64),
            rots.data_ptr(), transes.data_ptr(), Ks.data_ptr(), B, V, F, height, width,
            int(with_attrs), packed.data_ptr(), boxes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster pack kernel launch failed: cudaError {err}")
    pack_faces_cuda.launches += 1
    return packed, boxes


def render_depth_xyz_cuda(verts, faces, rots, transes, Ks, height: int, width: int,
                          need_xyz: bool = True):
    """Kernel B2 on CUDA tensors: (depth (B, H, W), xyz (B, H, W, 3) or None).

    verts (B, V, 3) object space, faces (B, F, 3) int, rots (B, 3, 3),
    transes (B, 3), Ks (B, 3, 3), all float32. Depth is 0 where no face
    covers the pixel centre (integer pixel coordinates).
    """
    _check_cuda_args(verts, faces, rots, transes, Ks, height, width)
    B, F, dev = verts.shape[0], faces.shape[1], verts.device
    depth = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    xyz = (torch.empty((B, height, width, 3), dtype=torch.float32, device=dev)
           if need_xyz else None)
    if depth.numel() == 0:
        return depth, xyz
    packed, boxes = pack_faces_cuda(verts, faces, rots, transes, Ks, height, width,
                                    with_attrs=need_xyz)
    with torch.cuda.device(dev):
        err = _kernels().gdrn_raster_fwd(
            packed.data_ptr(), boxes.data_ptr(), B, F, height, width, depth.data_ptr(),
            xyz.data_ptr() if need_xyz else None, int(need_xyz),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    render_depth_xyz_cuda.launches += 1
    return depth, xyz


render_depth_xyz_cuda.launches = 0
pack_faces_cuda.launches = 0
