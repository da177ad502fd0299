"""The reference's answer for a packed test batch: one pose per ROI slot."""

from __future__ import annotations

import numpy as np
import torch

from . import gdrn
from .geometry import roi_inputs
from .refine import depth_refine, mask_prob_l1

PN = gdrn.PN


def uses_depth(arch) -> bool:
    return bool(arch["input.with_depth"] or arch["val.use_depth_refine"])


@torch.no_grad()
def reference_poses(P: dict, arch: dict, batch: dict, extents: np.ndarray, bank_verts,
                    bank_faces, device, rows: int, block: int = 16):
    """Poses (R (rows, 3, 3), t (rows, 3)) of the first ``rows`` ROI slots of
    a host batch (the format the serving loop takes), computed ``block`` ROIs
    at a time. bank_verts (C, V, 3) and bank_faces (C, F, 3) are the meshes
    the depth refinement renders, in meters."""
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa
    images = torch.as_tensor(batch["images"], device=device)
    depths = f32(batch["depths"]) if uses_depth(arch) else None
    ext_bank = f32(extents)
    in_res, out_res = arch[PN + "input_res"], arch[PN + "output_res"]
    Rs, ts = [], []
    for b0 in range(0, rows, block):
        s = slice(b0, min(rows, b0 + block))
        idx = torch.as_tensor(batch["img_idx"][s], device=device).long()
        Ks = f32(batch["Ks"][s])
        labels = torch.as_tensor(batch["labels"][s], device=device).long()
        roi = roi_inputs(images, depths, idx, f32(batch["boxes_xyxy"][s]), Ks, in_res, out_res,
                         arch["model.pixel_mean"], arch["model.pixel_std"], arch["input.bp_depth"])
        out = gdrn.forward(P, arch, roi["roi_img"], roi["roi_depth"], labels,
                           roi["roi_coord_2d"], ext_bank[labels], Ks, roi["centers"],
                           roi["whs"], out_res / roi["scales"])
        t = out["trans"]
        if arch["val.use_depth_refine"]:
            t = depth_refine(out["rot"], t, mask_prob_l1(out["vis_mask"]), out["coor"],
                             roi["depth_out"], Ks, roi["centers"], roi["scales"],
                             f32(bank_verts)[labels], torch.as_tensor(bank_faces,
                                                                      device=device)[labels],
                             ext_bank[labels], arch["val.depth_refine_iters"],
                             arch["val.depth_refine_threshold"], out_res)
        Rs.append(out["rot"].cpu().numpy())
        ts.append(t.cpu().numpy())
    return np.concatenate(Rs), np.concatenate(ts)
