"""Synthetic GDRN batches for tests, exports and dry runs.

The port's copy of ``gdrnpp_bop2022_tpu/utils/fake_data.py`` (numpy only;
importing the JAX package would import jax): batches with the key / shape
contract of the real data pipeline (``engine/train_step.py`` and the GDRN
forward's arguments, channel-last), drawn from a seed, so a forward, a
train step or ``tools/export_model`` runs without BOP data on disk.
"""

from __future__ import annotations

import numpy as np


def fake_gdrn_batch(batch_size: int = 4, input_res: int = 256, output_res: int = 64,
                    num_classes: int = 21, num_regions: int = 64, num_points: int = 512,
                    seed: int = 0, with_bins: bool = False, xyz_bins: int = 64):
    """A random-but-plausible GDRN training batch (numpy, host-side)."""
    rs = np.random.RandomState(seed)
    B, H, W, R = batch_size, input_res, input_res, output_res

    z = rs.uniform(0.5, 1.5, B).astype(np.float32)
    trans = np.stack([rs.uniform(-0.1, 0.1, B), rs.uniform(-0.1, 0.1, B), z],
                     axis=1).astype(np.float32)
    # random rotations via QR
    A = rs.randn(B, 3, 3).astype(np.float32)
    Q = np.stack([np.linalg.qr(a)[0] for a in A])
    det = np.linalg.det(Q)
    Q[det < 0, :, 0] *= -1.0

    K = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                         dtype=np.float32), (B, 1, 1))
    centers = np.stack([rs.uniform(200, 450, B), rs.uniform(150, 350, B)],
                       axis=1).astype(np.float32)
    whs = rs.uniform(64, 160, (B, 2)).astype(np.float32)
    scales = whs.max(axis=1) * 1.5
    resize_ratios = (output_res / scales).astype(np.float32)

    batch = {
        "roi_img": rs.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
        "roi_labels": rs.randint(0, num_classes, B).astype(np.int32),
        "roi_coord_2d": rs.uniform(0, 1, (B, R, R, 2)).astype(np.float32),
        "roi_cams": K,
        "roi_centers": centers,
        "roi_whs": whs,
        "roi_extents": rs.uniform(0.05, 0.3, (B, 3)).astype(np.float32),
        "resize_ratios": resize_ratios,
        # ground truth ---------------------------------------------------
        "gt_xyz": rs.uniform(0, 1, (B, R, R, 3)).astype(np.float32),
        "gt_mask_trunc": (rs.uniform(0, 1, (B, R, R)) > 0.5).astype(np.float32),
        "gt_mask_visib": (rs.uniform(0, 1, (B, R, R)) > 0.5).astype(np.float32),
        "gt_mask_obj": (rs.uniform(0, 1, (B, R, R)) > 0.5).astype(np.float32),
        "gt_mask_full": (rs.uniform(0, 1, (B, R, R)) > 0.5).astype(np.float32),
        "gt_region": rs.randint(0, num_regions + 1, (B, R, R)).astype(np.int32),
        "gt_rot": Q.astype(np.float32),
        "gt_trans": trans,
        "gt_trans_ratio": rs.uniform(0, 1, (B, 3)).astype(np.float32),
        "gt_points": rs.uniform(-0.1, 0.1, (B, num_points, 3)).astype(np.float32),
    }
    if with_bins:
        batch["gt_xyz_bin"] = rs.randint(0, xyz_bins + 1, (B, R, R, 3)).astype(np.int32)
    return batch
