"""Batched z-buffer rasterizer: kernel B2's wrapper and its face packing.

``render_depth_xyz_cuda`` is the port of
``gdrnpp_bop2022_tpu/ops/pallas_raster.py::render_depth_xyz_pallas``: it
renders depth (B, H, W) and, with ``need_xyz``, object-space XYZ
(B, H, W, 3) of B posed meshes through the hand-written kernel
``csrc/raster.cu`` (built with nvcc at first use, without FMA
contraction). It takes CUDA tensors only and raises on anything else; the
dispatcher ``ops.rasterizer.render_depth_xyz`` sends CPU tensors to the
plain version. ``render_depth_xyz_cuda.launches`` counts kernel launches.

``_pack_face_data`` is the per-face preparation both versions share, as
torch gathers on the tensors' device (in the JAX package it is XLA outside
the Pallas kernel): projection with each ROI's K (skew included), then
per face x/y of its 3 vertices, their 1/z, a validity flag and 1/area,
plus the 9 attribute values in attribute mode, as rows of (B, 20|11, F).
"""

from __future__ import annotations

import ctypes

import torch

_MAX_ROIS = 65535       # grid.y of the launch
_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from ..utils.cuda_build import load_kernel_library
        fn = load_kernel_library("raster").gdrn_raster_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_cuda_args(verts, faces, rots, transes, Ks):
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
    if torch.is_grad_enabled() and verts.requires_grad:
        raise NotImplementedError("raster kernel is forward-only")


def render_depth_xyz_cuda(verts, faces, rots, transes, Ks, height: int, width: int,
                          need_xyz: bool = True):
    """Kernel B2 on CUDA tensors: (depth (B, H, W), xyz (B, H, W, 3) or None).

    verts (B, V, 3) object space, faces (B, F, 3) int, rots (B, 3, 3),
    transes (B, 3), Ks (B, 3, 3), all float32. Depth is 0 where no face
    covers the pixel centre (integer pixel coordinates).
    """
    if verts.device.type != "cuda":
        raise ValueError(f"render_depth_xyz_cuda takes CUDA tensors, got {verts.device}")
    _check_cuda_args(verts, faces, rots, transes, Ks)
    B, F = verts.shape[0], faces.shape[1]
    fd = _pack_face_data(transform_verts(verts, rots, transes), verts, faces, Ks,
                         with_attrs=need_xyz).contiguous()
    depth = torch.empty((B, height, width), dtype=torch.float32, device=verts.device)
    xyz = (torch.empty((B, height, width, 3), dtype=torch.float32, device=verts.device)
           if need_xyz else None)
    if depth.numel() == 0:
        return depth, xyz
    with torch.cuda.device(verts.device):
        err = _kernel()(fd.data_ptr(), B, fd.shape[1], F, height, width, depth.data_ptr(),
                        xyz.data_ptr() if need_xyz else None, int(need_xyz),
                        torch.cuda.current_stream(verts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed: cudaError {err}")
    render_depth_xyz_cuda.launches += 1
    return depth, xyz


render_depth_xyz_cuda.launches = 0
