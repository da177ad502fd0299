"""BOP pose-error metrics, batched.

Port of ``gdrnpp_bop2022_tpu/eval/pose_error.py`` (reference
lib/pysixd/pose_error.py: add :256, adi :274, re :359, te :406, proj :175,
mssd :131, mspd :156). Each ``*_batch`` metric is one batched computation
on the tensors' device; symmetry sets are padded banks (sym_R (B, S, 3, 3),
sym_t (B, S, 3), sym_valid (B, S)). VSD lives in ``eval/vsd.py``.

The single-instance wrappers (``add`` ... ``mspd``) take numpy arrays,
return a float and run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ADD-S: the (B, n, N) squared distances of one block of GT points stay
# below this many elements (a 21-class bank samples 3000 points per model)
ADI_MAX_BLOCK = 1 << 25


def _tf(pts, R, t):
    """pts (..., N, 3), R (..., 3, 3), t (..., 3) -> transformed points."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def add_batch(R_est, t_est, R_gt, t_gt, pts):
    """ADD: mean per-point distance. R (B,3,3), t (B,3), pts (B,N,3)."""
    d = _tf(pts, R_est, t_est) - _tf(pts, R_gt, t_gt)
    return torch.linalg.vector_norm(d, dim=-1).mean(dim=-1)


def adi_batch(R_est, t_est, R_gt, t_gt, pts, max_block: int = ADI_MAX_BLOCK):
    """ADD-S: mean nearest-neighbour distance from GT-posed to est-posed
    points, over blocks of GT points so (B, n, N) stays within max_block."""
    pe = _tf(pts, R_est, t_est)
    pg = _tf(pts, R_gt, t_gt)
    B, N = pe.shape[0], pe.shape[1]
    n_e = (pe * pe).sum(-1)
    step = max(1, max_block // max(B * N, 1))
    mins = []
    for i0 in range(0, N, step):
        g = pg[:, i0:i0 + step]
        d2 = (g * g).sum(-1)[:, :, None] + n_e[:, None, :] - 2.0 * (g @ pe.transpose(1, 2))
        mins.append(d2.amin(dim=-1))
    return torch.sqrt(torch.cat(mins, dim=1).clamp_min(0.0)).mean(dim=-1)


def re_batch(R_est, R_gt, degrees: bool = True):
    """Rotation geodesic error (reference pose_error.py:359-377)."""
    tr = (R_est * R_gt).sum(dim=(-2, -1))
    err = torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))
    return err * (180.0 / math.pi) if degrees else err


def te_batch(t_est, t_gt):
    return torch.linalg.vector_norm(t_est - t_gt, dim=-1)


def _project(pts, K, R, t):
    uvw = _tf(pts, R, t) @ K.transpose(-1, -2)
    return uvw[..., :2] / uvw[..., 2:3].clamp_min(1e-12)


def proj_batch(R_est, t_est, R_gt, t_gt, K, pts):
    """Mean 2D projection distance (Brachmann CVPR'16)."""
    d = _project(pts, K, R_est, t_est) - _project(pts, K, R_gt, t_gt)
    return torch.linalg.vector_norm(d, dim=-1).mean(dim=-1)


def _sym_gt_poses(R_gt, t_gt, sym_R, sym_t):
    """The GT pose composed with a padded symmetry bank: R_gt (B,3,3),
    t_gt (B,3), sym_R (B,S,3,3), sym_t (B,S,3) -> R (B,S,3,3), t (B,S,3)."""
    R = R_gt[:, None] @ sym_R
    t = (sym_t @ R_gt.transpose(1, 2)) + t_gt[:, None, :]
    return R, t


def mssd_batch(R_est, t_est, R_gt, t_gt, pts, sym_R, sym_t, sym_valid):
    """Maximum Symmetry-aware Surface Distance: min over the valid
    symmetries of the max per-point distance."""
    pe = _tf(pts, R_est, t_est)                                  # (B,N,3)
    Rs, ts = _sym_gt_poses(R_gt, t_gt, sym_R, sym_t)
    pg = _tf(pts[:, None], Rs, ts)                               # (B,S,N,3)
    maxd = torch.linalg.vector_norm(pe[:, None] - pg, dim=-1).amax(dim=-1)
    return torch.where(sym_valid, maxd, torch.full_like(maxd, math.inf)).amin(dim=-1)


def mspd_batch(R_est, t_est, R_gt, t_gt, K, pts, sym_R, sym_t, sym_valid):
    """Maximum Symmetry-aware Projection Distance."""
    prj_e = _project(pts, K, R_est, t_est)                       # (B,N,2)
    Rs, ts = _sym_gt_poses(R_gt, t_gt, sym_R, sym_t)
    prj_g = _project(pts[:, None], K[:, None], Rs, ts)           # (B,S,N,2)
    maxd = torch.linalg.vector_norm(prj_e[:, None] - prj_g, dim=-1).amax(dim=-1)
    return torch.where(sym_valid, maxd, torch.full_like(maxd, math.inf)).amin(dim=-1)


def cou_mask(mask_est, mask_gt):
    """Complement-over-union of binary masks (reference pose_error.py:219)."""
    mask_est, mask_gt = mask_est.bool(), mask_gt.bool()
    union = (mask_est | mask_gt).sum(dim=(-2, -1))
    inter = (mask_est & mask_gt).sum(dim=(-2, -1))
    return 1.0 - inter / union.clamp_min(1)


# ---------------------------------------------------------------------------
# single-instance wrappers (numpy in, float out)
# ---------------------------------------------------------------------------

def _b(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)[None]


def _bt(t, device):
    return _b(np.ravel(t), device)


def add(R_est, t_est, R_gt, t_gt, pts, device="cuda"):
    return float(add_batch(_b(R_est, device), _bt(t_est, device), _b(R_gt, device),
                           _bt(t_gt, device), _b(pts, device))[0])


def adi(R_est, t_est, R_gt, t_gt, pts, device="cuda"):
    return float(adi_batch(_b(R_est, device), _bt(t_est, device), _b(R_gt, device),
                           _bt(t_gt, device), _b(pts, device))[0])


def re(R_est, R_gt, device="cuda"):
    return float(re_batch(_b(R_est, device), _b(R_gt, device))[0])


def te(t_est, t_gt, device="cuda"):
    return float(te_batch(_bt(t_est, device), _bt(t_gt, device))[0])


def proj(R_est, t_est, R_gt, t_gt, K, pts, device="cuda"):
    return float(proj_batch(_b(R_est, device), _bt(t_est, device), _b(R_gt, device),
                            _bt(t_gt, device), _b(K, device), _b(pts, device))[0])


def _sym_bank_np(syms):
    """List of {"R", "t"} dicts -> (1,S,3,3), (1,S,3), (1,S) numpy arrays."""
    S = max(len(syms), 1)
    R = np.tile(np.eye(3, dtype=np.float32), (1, S, 1, 1))
    t = np.zeros((1, S, 3), np.float32)
    v = np.zeros((1, S), bool)
    for i, s in enumerate(syms):
        R[0, i] = s["R"]
        t[0, i] = np.ravel(s["t"])
        v[0, i] = True
    if not syms:
        v[0, 0] = True
    return R, t, v


def _sym_args(syms, device):
    sR, st, sv = _sym_bank_np(syms)
    return (torch.as_tensor(sR, device=device), torch.as_tensor(st, device=device),
            torch.as_tensor(sv, device=device))


def mssd(R_est, t_est, R_gt, t_gt, pts, syms, device="cuda"):
    return float(mssd_batch(_b(R_est, device), _bt(t_est, device), _b(R_gt, device),
                            _bt(t_gt, device), _b(pts, device), *_sym_args(syms, device))[0])


def mspd(R_est, t_est, R_gt, t_gt, K, pts, syms, device="cuda"):
    return float(mspd_batch(_b(R_est, device), _bt(t_est, device), _b(R_gt, device),
                            _bt(t_gt, device), _b(K, device), _b(pts, device),
                            *_sym_args(syms, device))[0])
