"""Farthest point sampling.

Port of ``gdrnpp_bop2022_tpu/ops/fps.py`` (reference
core/csrc/fps/src/farthest_point_sampling.cpp: greedy max-min selection,
optionally seeded from the point nearest the centroid). The JAX version is
a ``lax.scan`` of argmax / min over a running min-distance field; here it is
a loop of K - 1 steps on the device of ``pts``, with no host round trip.
``torch.argmax`` takes the first of equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


def _sq_dist(pts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    d = pts - p
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def fps_indices(pts: torch.Tensor, num_samples: int, init_center: bool = False) -> torch.Tensor:
    """Indices (K,) int64 of the greedy farthest points of pts (N, 3): the
    first is point 0, or with ``init_center`` the point nearest the
    centroid. The JAX version recovers the same indices by nearest match:
    a selected point is always the first of its duplicates."""
    if init_center:
        first = _sq_dist(pts, pts.mean(dim=0)).argmin()
    else:
        first = torch.zeros((), dtype=torch.int64, device=pts.device)
    idx = torch.empty(num_samples, dtype=torch.int64, device=pts.device)
    idx[0] = first
    min_d = _sq_dist(pts, pts[first])
    for k in range(1, num_samples):
        nxt = min_d.argmax()
        idx[k] = nxt
        min_d = torch.minimum(min_d, _sq_dist(pts, pts[nxt]))
    return idx


def farthest_point_sampling(pts: torch.Tensor, num_samples: int,
                            init_center: bool = False) -> torch.Tensor:
    """The K greedy farthest points (K, 3) of pts (N, 3)."""
    return pts[fps_indices(pts, num_samples, init_center)]
