"""3D model bank: BOP object models as padded per-class arrays.

Port of ``gdrnpp_bop2022_tpu/bop/models3d.py`` (numpy host code, kept close
to verbatim): models_info.json (diameters, extents, symmetries), per-class
padded vertex/face banks for the rasterizer, vertex-clustering mesh
decimation, FPS keypoints for the region labels, and uniformly sampled
surface points for the point-matching loss.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .inout import load_json, load_ply
from ..geometry.symmetry import get_symmetry_transformations


def load_models_info(models_dir: str) -> dict:
    """models_info.json keyed by int obj_id."""
    return load_json(os.path.join(models_dir, "models_info.json"), keys_to_int=True)


def decimate_mesh(pts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Vertex-clustering decimation onto a uniform grid.

    Simple, dependency-free: cluster vertices on a grid sized to roughly
    hit `target_faces`, collapse faces, drop degenerates. Good enough for
    low-res GT depth/XYZ rendering; exact silhouettes come from the
    full-res mesh if ever needed.
    """
    if faces is None or len(faces) <= target_faces:
        return pts, faces
    lo = pts.min(0)
    hi = pts.max(0)
    extent = np.maximum(hi - lo, 1e-9)

    def cluster(res):
        cell = extent / res
        key = np.floor((pts - lo) / cell).astype(np.int64)
        key = np.minimum(key, res - 1)
        key = key[:, 0] * res * res + key[:, 1] * res + key[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        counts = np.bincount(inv)
        new_pts = np.zeros((len(uniq), 3), np.float64)
        for d in range(3):
            new_pts[:, d] = np.bincount(inv, weights=pts[:, d]) / counts
        new_faces = inv[faces]
        ok = ((new_faces[:, 0] != new_faces[:, 1])
              & (new_faces[:, 1] != new_faces[:, 2])
              & (new_faces[:, 0] != new_faces[:, 2]))
        new_faces = new_faces[ok]
        sf = np.sort(new_faces, axis=1)
        _, keep = np.unique(sf, axis=0, return_index=True)
        return new_pts.astype(pts.dtype), new_faces[np.sort(keep)].astype(faces.dtype)

    # coarse-to-fine: grow the grid until face count would exceed target,
    # return the finest clustering still within budget
    best = cluster(4)
    res = 6
    while res <= 512:
        cand = cluster(res)
        if len(cand[1]) > target_faces:
            break
        best = cand
        res = int(np.ceil(res * 1.4))
    return best


def _sample_surface_points(pts, faces, n, seed=0):
    """Area-weighted uniform surface sampling (for PM-loss point banks)."""
    rs = np.random.RandomState(seed)
    if faces is None or len(faces) == 0:
        idx = rs.choice(len(pts), size=n, replace=len(pts) < n)
        return pts[idx]
    v0, v1, v2 = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-12)
    fi = rs.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rs.uniform(size=(n, 1)))
    r2 = rs.uniform(size=(n, 1))
    return (1 - r1) * v0[fi] + r1 * (1 - r2) * v1[fi] + r1 * r2 * v2[fi]


def _fps_numpy(pts, k, init_center=True):
    first = int(np.argmin(((pts - pts.mean(0)) ** 2).sum(1))) if init_center else 0
    idxs = [first]
    d = ((pts - pts[first]) ** 2).sum(1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        idxs.append(nxt)
        d = np.minimum(d, ((pts - pts[nxt]) ** 2).sum(1))
    return pts[idxs]


@dataclass
class ModelBank:
    """Padded per-class model arrays (numpy, on the host; callers move
    what they need to the device with torch.as_tensor).

    All geometry in meters (BOP models are mm; vertex_scale=0.001 default,
    matching the reference's 1e-3 scaling in data loading).
    """
    obj_ids: Sequence[int]
    verts: np.ndarray          # (C, Vmax, 3) padded with 0
    faces: np.ndarray          # (C, Fmax, 3) padded with (0,0,0) degenerate
    points: np.ndarray         # (C, P, 3) surface samples for PM loss
    fps_points: np.ndarray     # (C, R, 3) region keypoints
    extents: np.ndarray        # (C, 3) bbox extents
    diameters: np.ndarray      # (C,)
    sym_rotations: list        # per-class list of (S_c, 3, 3) or None
    sym_translations: list     # per-class list of (S_c, 3) meters or None
    centers: np.ndarray = None  # (C, 3) bbox centers

    @classmethod
    def from_bop_models_dir(
        cls,
        models_dir: str,
        obj_ids: Optional[Sequence[int]] = None,
        vertex_scale: float = 1e-3,
        max_faces: int = 4096,
        num_points: int = 3000,
        num_fps: int = 64,
        max_sym_disc_step: float = 0.01,
    ) -> "ModelBank":
        infos = load_models_info(models_dir)
        if obj_ids is None:
            obj_ids = sorted(infos.keys())
        verts_list, faces_list, pts_list, fps_list = [], [], [], []
        extents, diameters, sym_rots, sym_ts = [], [], [], []
        centers = []
        for oid in obj_ids:
            ply = load_ply(os.path.join(models_dir, f"obj_{oid:06d}.ply"),
                           vertex_scale=vertex_scale)
            pts, faces = ply["pts"], ply.get("faces")
            dpts, dfaces = decimate_mesh(pts, faces, max_faces)
            verts_list.append(dpts)
            faces_list.append(dfaces if dfaces is not None else np.zeros((0, 3), np.int64))
            surf = _sample_surface_points(pts, faces, num_points)
            pts_list.append(surf)
            fps_list.append(_fps_numpy(surf, num_fps, init_center=True))
            info = infos[oid]
            extents.append(np.array([info["size_x"], info["size_y"], info["size_z"]])
                           * vertex_scale)
            diameters.append(info["diameter"] * vertex_scale)
            centers.append(np.array([
                info["min_x"] + info["size_x"] / 2.0,
                info["min_y"] + info["size_y"] / 2.0,
                info["min_z"] + info["size_z"] / 2.0]) * vertex_scale)
            if "symmetries_discrete" in info or "symmetries_continuous" in info:
                trans = get_symmetry_transformations(info, max_sym_disc_step)
                sym_rots.append(np.stack([t["R"] for t in trans]))
                # BOP symmetries are full 4x4 transforms; translations are in
                # model units (mm) -> scale to meters with the vertices
                sym_ts.append(np.stack([t["t"].ravel() for t in trans])
                              * vertex_scale)
            else:
                sym_rots.append(None)
                sym_ts.append(None)

        C = len(obj_ids)
        Vmax = max(len(v) for v in verts_list)
        Fmax = max(max(len(f) for f in faces_list), 1)
        verts = np.zeros((C, Vmax, 3), np.float32)
        faces = np.zeros((C, Fmax, 3), np.int32)
        for i, (v, f) in enumerate(zip(verts_list, faces_list)):
            verts[i, :len(v)] = v
            faces[i, :len(f)] = f
        return cls(
            obj_ids=list(obj_ids),
            verts=verts,
            faces=faces,
            points=np.stack(pts_list).astype(np.float32),
            fps_points=np.stack(fps_list).astype(np.float32),
            extents=np.stack(extents).astype(np.float32),
            diameters=np.asarray(diameters, np.float32),
            sym_rotations=sym_rots,
            sym_translations=sym_ts,
            centers=np.stack(centers).astype(np.float32),
        )

    def sym_bank(self, max_syms: Optional[int] = None):
        """(bank (C,S,3,3), mask (C,S)) for the device-side closest-rot."""
        from ..geometry.symmetry import build_sym_bank
        return build_sym_bank(self.sym_rotations, max_syms)
