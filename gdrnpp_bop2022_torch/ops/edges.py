"""Batched Canny-style edges: Gaussian blur, Sobel gradients, non-maximum
suppression along the quantised gradient direction, a threshold.

Port of ``gdrnpp_bop2022_tpu/ops/edges.py`` (reference
core/utils/edge_utils.py). The JAX version's convolutions (a separable
5-tap Gaussian and the 3x3 Sobel pair, zero padding, cross-correlation)
are written here as shifted fp32 sums: cuDNN would run an fp32 convolution
in TF32 by default on the card. The direction bin is
``round(angle / (pi / 4)) mod 4`` with round half to even and a floor
modulus (``torch.remainder``), as ``jnp.round(...) % 4`` computes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gauss_kernel(size: int = 5, std: float = 1.0) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / std) ** 2)
    return (k / k.sum()).astype(np.float32)


def shift(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = m[..., y - dy, x - dx], zero outside (|dy|, |dx| <= 2)."""
    H, W = m.shape[-2:]
    p = F.pad(m, (2, 2, 2, 2))
    return p[..., 2 - dy:2 - dy + H, 2 - dx:2 - dx + W]


def sep_blur(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """(B, H, W) blurred by the odd 1-D kernel k along x, then along y."""
    r = len(k) // 2
    x = sum(float(k[j]) * shift(img, 0, r - j) for j in range(len(k)))
    return sum(float(k[j]) * shift(x, r - j, 0) for j in range(len(k)))


def sobel_gradients(img: torch.Tensor):
    """(B, H, W) -> (gx, gy), the 3x3 Sobel cross-correlations
    [[1, 0, -1], [2, 0, -2], [1, 0, -1]] and its transpose."""
    a, b, c = shift(img, 1, 1), shift(img, 1, 0), shift(img, 1, -1)      # row y - 1
    d, f = shift(img, 0, 1), shift(img, 0, -1)                            # row y
    g, h, i = shift(img, -1, 1), shift(img, -1, 0), shift(img, -1, -1)   # row y + 1
    gx = a - c + 2.0 * d - 2.0 * f + g - i
    gy = a + 2.0 * b + c - g - 2.0 * h - i
    return gx, gy


def canny_edges(images: torch.Tensor, low_threshold: float = 10.0) -> torch.Tensor:
    """Thinned edges above ``low_threshold``: (B, H, W) bool, from grayscale
    (B, H, W) or RGB (B, H, W, 3) images in [0, 255]."""
    img = images.float()
    if img.dim() == 4:
        img = img.mean(dim=-1)
    gx, gy = sobel_gradients(sep_blur(img, gauss_kernel()))
    mag = torch.sqrt(gx * gx + gy * gy)
    d = torch.remainder(torch.round(torch.atan2(gy, gx) / (math.pi / 4)).to(torch.int32), 4)
    neigh = ((shift(mag, 0, 1), shift(mag, 0, -1)),      # E-W
             (shift(mag, 1, 1), shift(mag, -1, -1)),     # NE-SW
             (shift(mag, 1, 0), shift(mag, -1, 0)),      # N-S
             (shift(mag, 1, -1), shift(mag, -1, 1)))     # NW-SE
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for k, (a, b) in enumerate(neigh):
        keep = torch.where(d == k, (mag >= a) & (mag >= b), keep)
    return keep & (mag > low_threshold)
