"""Object symmetries: enumeration (host, numpy) and closest-rotation
selection (device, batched torch).

Port of ``gdrnpp_bop2022_tpu/geometry/symmetry.py``. The enumeration follows
the BOP toolkit (lib/pysixd/misc.py:234-280 of the reference); the closest
symmetric GT rotation (pose_utils.py:472-528 of the reference) is a masked
argmax over a padded per-class bank, so it needs no per-sample loop.
"""

from __future__ import annotations

import numpy as np
import torch


def _axis_angle_matrix(angle: float, axis: np.ndarray) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def get_symmetry_transformations(model_info: dict, max_sym_disc_step: float = 0.01):
    """Symmetry transformations of a BOP object model: a list of dicts
    {"R": 3x3, "t": 3x1} (t in the model's units, typically mm), identity
    first, as the BOP toolkit gives them."""
    trans_disc = [{"R": np.eye(3), "t": np.zeros((3, 1))}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, dtype=np.float64), (4, 4))
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3].reshape(3, 1)})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64)
        offset = np.asarray(sym["offset"], dtype=np.float64).reshape(3, 1)
        n_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n_steps
        for i in range(1, n_steps):
            R = _axis_angle_matrix(i * step, axis)
            trans_cont.append({"R": R, "t": -(R @ offset) + offset})

    out = []
    for td in trans_disc:
        if trans_cont:
            for tc in trans_cont:
                out.append({"R": tc["R"] @ td["R"], "t": tc["R"] @ td["t"] + tc["t"]})
        else:
            out.append(td)
    return out


def get_symmetry_rotations(model_info: dict, max_sym_disc_step: float = 0.01) -> np.ndarray:
    """Rotation-only symmetry bank (K, 3, 3); identity first."""
    return np.stack([t["R"] for t in get_symmetry_transformations(model_info, max_sym_disc_step)])


def build_sym_bank(sym_rots_per_class: list, max_syms: int | None = None):
    """Per-class symmetry rotation lists -> a fixed (C, S, 3, 3) bank.

    A class without symmetries gets a single identity; padding repeats the
    identity and is masked out. Returns (bank (C, S, 3, 3) float32 tensor,
    mask (C, S) bool tensor), on the CPU.
    """
    C = len(sym_rots_per_class)
    sizes = [1 if r is None else len(r) for r in sym_rots_per_class]
    S = max_syms or max(sizes + [1])
    bank = np.tile(np.eye(3, dtype=np.float32), (C, S, 1, 1))
    mask = np.zeros((C, S), dtype=bool)
    for c, rots in enumerate(sym_rots_per_class):
        if rots is None:
            mask[c, 0] = True
            continue
        k = min(len(rots), S)
        bank[c, :k] = np.asarray(rots[:k], dtype=np.float32)
        mask[c, :k] = True
    return torch.from_numpy(bank), torch.from_numpy(mask)


def get_closest_rot_batch(pred_rots: torch.Tensor, gt_rots: torch.Tensor,
                          sym_bank: torch.Tensor, sym_mask: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-sample closest symmetric GT rotation gt_rot @ R_sym (m2m
    convention, reference pose_utils.py:490): the one with the largest
    trace(pred^T gt_sym), i.e. the smallest geodesic distance to pred_rot.

    pred_rots, gt_rots (B, 3, 3); sym_bank (C, S, 3, 3); sym_mask (C, S);
    labels (B,). No gradient flows through the selection.
    """
    labels = labels.long()
    syms = sym_bank[labels]                                      # (B, S, 3, 3)
    valid = sym_mask[labels]                                     # (B, S)
    gt_sym = torch.einsum("bij,bsjk->bsik", gt_rots, syms)
    tr = torch.einsum("bij,bsij->bs", pred_rots.detach(), gt_sym)
    tr = torch.where(valid, tr, torch.full_like(tr, -float("inf")))
    idx = torch.argmax(tr, dim=-1)
    return gt_sym[torch.arange(gt_sym.shape[0], device=gt_sym.device), idx]
