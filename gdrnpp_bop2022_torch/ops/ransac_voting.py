"""PVNet-style RANSAC keypoint voting.

Port of ``gdrnpp_bop2022_tpu/ops/ransac_voting.py`` (reference
core/csrc/ransac_voting: generate_hypothesis / voting_for_hypothesis and the
wrapper loop ransac_voting_gpu.py). Pixels vote with unit directions toward a
keypoint; hypotheses are the intersections of the voting lines of random
pixel pairs, scored by counting the pixels whose direction agrees with the
hypothesis to a cosine above the threshold; the best hypothesis is refined
by the inlier-weighted least-squares intersection. A fixed hypothesis budget
stands for the reference's early exit, as in the JAX version.

The JAX version draws the pixel pairs with ``jax.random.categorical``,
uniform over the mask (over every pixel when the mask is empty); here they
come from ``torch.multinomial`` with a ``torch.Generator``, or from the
caller (``idx1`` / ``idx2``), which is how the tests replay the JAX draws.
JAX vmaps over images and keypoints; scoring one keypoint builds an
(n_hyps, pixels, 2) tensor (~315 MB at 480x640 and 128 hypotheses), so
``ransac_voting_layer`` loops over images and keypoints, which are
independent, and the peak stays at about a gigabyte.
"""

from __future__ import annotations

from typing import Optional

import torch


def _line_intersection(p1, d1, p2, d2, eps: float = 1e-8):
    """Intersections of the lines p1 + t d1 and p2 + s d2, all (H, 2):
    (points (H, 2), ok (H,): the lines are not parallel)."""
    a00, a10 = d1[:, 0], d1[:, 1]
    a01, a11 = -d2[:, 0], -d2[:, 1]
    det = a00 * a11 - a01 * a10
    rhs = p2 - p1
    t = (rhs[:, 0] * a11 - rhs[:, 1] * a01) / torch.where(det.abs() < eps, float("inf"), det)
    return p1 + t[:, None] * d1, det.abs() > eps


def draw_pixels(mask: torch.Tensor, n: int, generator: Optional[torch.Generator] = None):
    """n pixel indices drawn uniformly over the mask (P,) with replacement,
    over every pixel if the mask is empty."""
    w = mask.float()
    w = torch.where(mask.any(), w, torch.ones_like(w))
    return torch.multinomial(w, n, replacement=True, generator=generator)


def ransac_voting_keypoint(coords: torch.Tensor, directions: torch.Tensor, mask: torch.Tensor,
                           n_hyps: int = 128, inlier_thresh: float = 0.999, *,
                           generator: Optional[torch.Generator] = None,
                           idx1: Optional[torch.Tensor] = None,
                           idx2: Optional[torch.Tensor] = None):
    """Vote one keypoint. coords (P, 2) pixel coordinates, directions (P, 2)
    unit votes, mask (P,) bool. Returns (point (2,), inlier fraction,
    mean (2,), cov (2, 2)) of the hypotheses with a positive score."""
    if idx1 is None:
        idx1 = draw_pixels(mask, n_hyps, generator)
    if idx2 is None:
        idx2 = draw_pixels(mask, n_hyps, generator)
    hyp, ok = _line_intersection(coords[idx1], directions[idx1], coords[idx2], directions[idx2])

    # a pixel votes for h if the cosine between its direction and h - pixel
    # is above the threshold
    diff = hyp[:, None, :] - coords[None, :, :]                         # (H, P, 2)
    dn = diff / torch.linalg.vector_norm(diff, dim=-1, keepdim=True).clamp_min(1e-8)
    cos = dn[..., 0] * directions[None, :, 0] + dn[..., 1] * directions[None, :, 1]
    inlier = (cos > inlier_thresh) & mask[None]
    scores = torch.where(ok, inlier.sum(-1), -1)
    best_inliers = inlier[scores.argmax()].float()                      # (P,)
    n_in = best_inliers.sum().clamp_min(1.0)

    # least squares over the inliers' lines: normal equations of the
    # squared perpendicular distances
    n_vec = torch.stack([-directions[:, 1], directions[:, 0]], dim=-1)  # line normals
    wn = best_inliers[:, None] * n_vec
    A = (wn[:, :, None] * n_vec[:, None, :]).sum(0)
    b = (wn * (n_vec * coords).sum(-1, keepdim=True)).sum(0)
    eye = torch.eye(2, dtype=A.dtype, device=A.device)
    refined = torch.linalg.solve(A + 1e-6 * eye, b)

    # mean and covariance of the hypotheses with a positive score (reference
    # estimate_voting_distribution_with_mean)
    pos = (scores > 0)[:, None]
    nh = pos.sum().clamp_min(1)
    mean = torch.where(pos, hyp, 0.0).sum(0) / nh
    d = torch.where(pos, hyp - mean, 0.0)
    cov = (d[:, :, None] * d[:, None, :]).sum(0) / (nh - 1).clamp_min(1)
    return refined, n_in / mask.sum().clamp_min(1), mean, cov


def ransac_voting_layer(mask: torch.Tensor, vertex: torch.Tensor, n_hyps: int = 128, *,
                        generator: Optional[torch.Generator] = None,
                        idx1: Optional[torch.Tensor] = None,
                        idx2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keypoints (B, K, 2) voted from foreground masks (B, H, W) and vote
    fields vertex (B, H, W, K, 2) (reference ransac_voting_layer_v3).
    ``idx1`` / ``idx2`` (B, K, n_hyps), where given, are the drawn pixels."""
    B, H, W, K, _ = vertex.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=vertex.device),
                            torch.arange(W, dtype=torch.float32, device=vertex.device),
                            indexing="ij")
    coords = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    out = torch.empty((B, K, 2), dtype=vertex.dtype, device=vertex.device)
    for i in range(B):
        mflat = mask[i].reshape(-1) > 0.5
        for k in range(K):
            d = vertex[i, :, :, k].reshape(-1, 2)
            d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)
            out[i, k] = ransac_voting_keypoint(
                coords, d, mflat, n_hyps, generator=generator,
                idx1=None if idx1 is None else idx1[i, k],
                idx2=None if idx2 is None else idx2[i, k])[0]
    return out
