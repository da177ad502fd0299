"""Batched PnP: DLT initialisation, Levenberg-Marquardt refinement and a
fixed-hypothesis RANSAC.

Port of ``gdrnpp_bop2022_tpu/ops/pnp.py``, the counterpart of three
reference paths: cv2.solvePnP in the evaluator's PnP modes
(gdrn_evaluator.py:241-459), the ceres LM of the uncertainty-PnP extension
(core/csrc/uncertainty_pnp/src/uncertainty_pnp.cpp:7-56: reprojection
residuals premultiplied by per-point weights) and the PVNet RANSAC voting
kernels (hypotheses as batched minimal subsets scored in parallel).

Every shape is static and nothing waits on the device inside a solve: LM
runs a fixed number of iterations with accept/reject by ``torch.where``,
its 6x6 systems go through ``torch.linalg.solve_ex`` (no error check that
would sync the host), and RANSAC scores a fixed hypothesis count with
masked inlier counts.
"""

from __future__ import annotations

from typing import Optional

import torch


def normalize_points_2d(pts2d, K):
    """Pixel coords -> normalised camera coords. pts2d (..., N, 2), K (..., 3, 3)."""
    x = (pts2d[..., 0] - K[..., 0, 2, None]) / K[..., 0, 0, None]
    y = (pts2d[..., 1] - K[..., 1, 2, None]) / K[..., 1, 1, None]
    return torch.stack([x, y], dim=-1)


def dlt_pnp(pts3d, pts2d_norm, weights=None):
    """Direct Linear Transform PnP on normalised coords (batched).

    P = [R|t] up to scale is the right singular vector of the smallest
    singular value of the 2N x 12 system, taken here as the eigenvector of
    the smallest eigenvalue of AᵀA in float64 (batched 12x12 ``eigh``: no
    SVD of a tall matrix per ROI, and at least as accurate as an fp32 SVD);
    its sign is fixed so the points' centroid has positive depth, and its
    3x3 block is projected onto SO(3) with a reflection guard.

    pts3d (B, N, 3), pts2d_norm (B, N, 2), weights (B, N) optional.
    Returns (R (B, 3, 3), t (B, 3)) in the input dtype.
    """
    B, N, _ = pts3d.shape
    dt = pts3d.dtype
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1).double()  # (B,N,4)
    u = pts2d_norm[..., 0:1].double()
    v = pts2d_norm[..., 1:2].double()
    zero = torch.zeros_like(X)
    A = torch.cat([torch.cat([X, zero, -u * X], dim=-1),
                   torch.cat([zero, X, -v * X], dim=-1)], dim=1)          # (B, 2N, 12)
    if weights is not None:
        w = torch.sqrt(torch.cat([weights, weights], dim=1).double().clamp_min(0.0))
        A = A * w[..., None]
    _, vecs = torch.linalg.eigh(A.transpose(1, 2) @ A)                   # ascending
    P = vecs[..., 0].reshape(B, 3, 4)
    # the global sign: the point centroid at positive depth
    centroid_h = torch.cat([pts3d.double().mean(dim=1), X.new_ones(B, 1)], dim=-1)
    w_c = (P[:, 2, :] * centroid_h).sum(-1)
    P = P * torch.sign(w_c)[:, None, None]
    M = P[:, :, :3]
    # nearest rotation (scaled): SVD projection with a reflection guard
    um, sm, vmt = torch.linalg.svd(M)
    det = torch.linalg.det(um @ vmt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (um * d[:, None, :]) @ vmt
    t = P[:, :, 3] / sm.mean(dim=-1, keepdim=True).clamp_min(1e-12)
    return R.to(dt), t.to(dt)


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _rodrigues(w):
    """Axis-angle (..., 3) -> rotation matrices, small-angle safe."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp_min(1e-12)
    Km = _skew(w / theta)
    st = torch.sin(theta)[..., None]
    ct = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + st * Km + (1 - ct) * (Km @ Km)


def _log_so3(R):
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    tr = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) * 0.5,
                     -1 + 1e-7, 1 - 1e-7)
    theta = torch.arccos(tr)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = theta / torch.clamp_min(2.0 * torch.sin(theta), 1e-9)
    return w * s[..., None]


def _residuals(params, pts3d, pts2d_norm):
    """params (..., 6): [axis-angle, t]. Returns (..., N, 2) residuals."""
    R = _rodrigues(params[..., :3])
    pc = pts3d @ R.transpose(-1, -2) + params[..., None, 3:]
    z = pc[..., 2].clamp_min(1e-9)
    return pc[..., :2] / z[..., None] - pts2d_norm


def _jacobian(params, pts3d):
    """d residuals / d params of ``_residuals``: (B, N, 2, 6), closed form.

    With q = R(w) X and p = q + t: d p / d t = I and d p / d w =
    -[q]x R Jr(w), Jr the right Jacobian of SO(3) (Jr = I - (1 - cos a) / a^2
    [w]x + (a - sin a) / a^3 [w]x^2, a = |w|); the projection p -> p_xy / z
    contributes [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]], with no z column where
    z is clamped at 1e-9 (as the clamp's derivative)."""
    w = params[:, :3]
    a = torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-12)[:, None, None]
    W = _skew(w)
    c1 = 2.0 * torch.sin(0.5 * a) ** 2 / (a * a)                      # (1 - cos a) / a^2
    c2 = torch.where(a < 1e-2, 1.0 / 6.0 - a * a / 120.0, (a - torch.sin(a)) / a ** 3)
    eye = torch.eye(3, dtype=params.dtype, device=params.device)
    R = _rodrigues(w)
    M = R @ (eye - c1 * W + c2 * (W @ W))                               # (B, 3, 3)
    q = pts3d @ R.transpose(-1, -2)                                     # (B, N, 3)
    pc = q + params[:, None, 3:]
    zc = pc[..., 2].clamp_min(1e-9)
    inv = 1.0 / zc
    dz = torch.where(pc[..., 2] > 1e-9, -inv * inv, torch.zeros_like(inv))
    zero = torch.zeros_like(inv)
    Dpi = torch.stack([torch.stack([inv, zero, pc[..., 0] * dz], -1),
                       torch.stack([zero, inv, pc[..., 1] * dz], -1)], -2)  # (B, N, 2, 3)
    J_w = -(Dpi @ _skew(q)) @ M[:, None]
    return torch.cat([J_w, Dpi], dim=-1)


def lm_refine_pnp(R0, t0, pts3d, pts2d_norm, weights=None, iters: int = 10,
                  lm_lambda: float = 1e-3):
    """Fixed-iteration Levenberg-Marquardt on the weighted reprojection error.

    The counterpart of the ceres solve in uncertainty_pnp.cpp: weights
    (B, N, 2) or (B, N) multiply the residuals like the reference's 2x2
    inverse-sqrt-covariance premultiplication (diagonal case). The Jacobian
    is ``_jacobian``'s closed form; a step is kept only where it lowers
    the cost.
    Returns (R (B, 3, 3), t (B, 3)).
    """
    B, N, _ = pts3d.shape
    if weights is None:
        w = torch.ones((B, N, 2), dtype=pts3d.dtype, device=pts3d.device)
    elif weights.dim() == 2:
        w = weights[..., None].expand(B, N, 2).to(pts3d.dtype)
    else:
        w = weights.to(pts3d.dtype)

    cost = lambda p: ((_residuals(p, pts3d, pts2d_norm) * w) ** 2).sum(dim=(1, 2))  # noqa: E731
    p = torch.cat([_log_so3(R0), t0], dim=-1)                          # (B, 6)
    lam = torch.full((B,), lm_lambda, dtype=p.dtype, device=p.device)
    eye = torch.eye(6, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        r = (_residuals(p, pts3d, pts2d_norm) * w).reshape(B, -1)      # (B, 2N)
        J = (_jacobian(p, pts3d) * w[..., None]).reshape(B, -1, 6)     # (B, 2N, 6)
        JtJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        H = JtJ + lam[:, None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=1, dim2=2))
        dp = torch.linalg.solve_ex(H + 1e-12 * eye, g)[0]
        p_new = p - dp
        better = cost(p_new) < (r * r).sum(-1)
        p = torch.where(better[:, None], p_new, p)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return _rodrigues(p[:, :3]), p[:, 3:]


def ransac_hypotheses(mask, n_hyps: int, subset_size: int,
                      generator: Optional[torch.Generator] = None):
    """Point indices (H, B, S) of RANSAC's minimal subsets: uniform draws
    with replacement over each ROI's valid points, over all of its points
    where none is valid (``jax.random.categorical`` with logits 0 / -1e9)."""
    B, N = mask.shape
    wts = mask.float()
    wts = torch.where(wts.sum(-1, keepdim=True) > 0, wts, torch.ones_like(wts))
    idx = torch.multinomial(wts, n_hyps * subset_size, replacement=True,
                            generator=generator)                      # (B, H*S)
    return idx.reshape(B, n_hyps, subset_size).permute(1, 0, 2)


def ransac_pnp(pts3d, pts2d, K, mask=None, n_hyps: int = 64, subset_size: int = 8,
               inlier_thresh_px: float = 3.0, refine_iters: int = 10,
               generator: Optional[torch.Generator] = None, idx=None):
    """RANSAC PnP with a fixed hypothesis count and masked scoring.

    pts3d (B, N, 3), pts2d (B, N, 2) pixels, K (B, 3, 3), mask (B, N)
    valid correspondences. The subsets come from ``idx`` (H, B, S) when the
    caller draws them, else from ``ransac_hypotheses`` with ``generator``.
    Returns (R (B, 3, 3), t (B, 3), inlier_frac (B,)).
    """
    B, N, _ = pts3d.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=pts3d.device)
    pts2d_norm = normalize_points_2d(pts2d, K)
    thresh_norm = inlier_thresh_px / torch.minimum(K[:, 0, 0], K[:, 1, 1]).clamp_min(1.0)
    if idx is None:
        idx = ransac_hypotheses(mask, n_hyps, subset_size, generator)
    H, _, S = idx.shape
    idx = idx.long()
    gather = lambda a: torch.gather(                                  # noqa: E731
        a[None].expand(H, -1, -1, -1), 2,
        idx[..., None].expand(-1, -1, -1, a.shape[-1])).reshape(H * B, S, a.shape[-1])
    Rs, ts = dlt_pnp(gather(pts3d), gather(pts2d_norm))
    Rs, ts = Rs.reshape(H, B, 3, 3), ts.reshape(H, B, 3)

    def inliers(R, t):
        pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
        z = pc[..., 2]
        proj = pc[..., :2] / z.clamp_min(1e-9)[..., None]
        err = torch.linalg.vector_norm(proj - pts2d_norm, dim=-1)
        return (err < thresh_norm[:, None]) & (z > 1e-6) & mask

    best = inliers(Rs, ts).sum(-1).argmax(dim=0)                      # (B,) first max
    ar = torch.arange(B, device=pts3d.device)
    R0, t0 = Rs[best, ar], ts[best, ar]
    # refine on the inliers of the best hypothesis
    inl = inliers(R0, t0).to(pts3d.dtype)
    R, t = lm_refine_pnp(R0, t0, pts3d, pts2d_norm, weights=inl, iters=refine_iters)
    inlier_frac = inl.sum(-1) / mask.sum(-1).clamp_min(1)
    return R, t, inlier_frac


def uncertainty_pnp(pts3d, pts2d, weights_2d, K, R0=None, t0=None, iters: int = 15):
    """Weighted PnP (reference un_pnp_utils.py:11 interface): per-point 2D
    confidence weights (B, N) or (B, N, 2); seeds from DLT without an
    initialisation."""
    pts2d_norm = normalize_points_2d(pts2d, K)
    if R0 is None or t0 is None:
        w = weights_2d if weights_2d.dim() == 2 else weights_2d.mean(-1)
        R0, t0 = dlt_pnp(pts3d, pts2d_norm, weights=w)
    return lm_refine_pnp(R0, t0, pts3d, pts2d_norm, weights=weights_2d, iters=iters)
