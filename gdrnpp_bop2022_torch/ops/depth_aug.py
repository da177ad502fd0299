"""Depth augmentation and smoothing, batched on the depth's device.

Port of ``gdrnpp_bop2022_tpu/ops/depth_aug.py`` (reference
core/utils/depth_aug.py, as data_loader.py:409-431 uses it, and
core/utils/depth_image_smoothing.py). As in ``ops/color_aug.py``, each
augmentation is a ``draw_*(gen, ...)`` that draws every random number from
an explicit ``torch.Generator`` and a pure function of the depth and the
draws. Depth is (B, H, W) in meters.
"""

from __future__ import annotations

import math

import torch

from .color_aug import _nearest_index, _rand


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def draw_add_noise_depth(gen: torch.Generator, shape, noise_std: float = 0.005,
                         hole_prob: float = 0.01, hole_size: int = 4,
                         scale_std: float = 0.005) -> dict:
    """Draws of ``add_noise_depth`` for depth of ``shape`` (B, H, W)."""
    B, H, W = shape
    gh, gw = max(H // hole_size, 1), max(W // hole_size, 1)
    return {"scale": 1.0 + scale_std * _randn(gen, B, 1, 1),
            "noise": noise_std * _randn(gen, B, H, W),
            "holes": (_rand(gen, B, gh, gw) < hole_prob).float()}


def add_noise_depth(depth: torch.Tensor, draws: dict) -> torch.Tensor:
    """Sensor-like corruption: a per-image scale jitter, additive gaussian
    noise, and holes (a coarse grid resized nearest to the image)."""
    H, W = depth.shape[1], depth.shape[2]
    holes = draws["holes"]
    holes = holes[:, _nearest_index(holes.shape[1], H, depth.device)]
    holes = holes[:, :, _nearest_index(holes.shape[2], W, depth.device)]
    noisy = depth * draws["scale"] + draws["noise"]
    keep = (depth > 1e-6) & (holes < 0.5)
    return torch.where(keep, noisy, torch.zeros_like(noisy))


def draw_gdrn_depth_aug(gen: torch.Generator, shape, fill_std: float = 0.1,
                        drop_prob: float = 0.5, drop_ratio: float = 0.2,
                        noise_prob: float = 0.9, noise_level: float = 0.005) -> dict:
    """Draws of ``gdrn_depth_aug`` for depth of ``shape`` (B, H, W): the
    fill noise, the per-sample drop coin and per-pixel keep mask, the
    per-sample noise coin and the noise (a per-image level ~ U(0,
    noise_level) times a standard normal field)."""
    B, H, W = shape
    return {"fill": fill_std * _randn(gen, B, H, W),
            "do_drop": _rand(gen, B, 1, 1) < drop_prob,
            "keep": _rand(gen, B, H, W) > drop_ratio,
            "do_noise": _rand(gen, B, 1, 1) < noise_prob,
            "gauss": (noise_level * _rand(gen, B, 1, 1)) * _randn(gen, B, H, W)}


def gdrn_depth_aug(depth: torch.Tensor, draws: dict) -> torch.Tensor:
    """The reference's train-time depth corruption (data_loader.py:414-427):

      1. zero pixels are filled with the fill noise (N(0, fill_std): the
         median of the zero region is 0);
      2. where the sample's drop coin fell, pixels outside the keep mask
         are zeroed (~drop_ratio of them);
      3. where the sample's noise coin fell, the noise is added to the
         pixels still > 0.

    Coins are per batch element where the reference flips per image: the
    same distribution over a batch."""
    zero = torch.zeros_like(depth)
    filled = torch.where(depth <= 0.0, draws["fill"], depth)
    dropped = torch.where(draws["do_drop"] & ~draws["keep"], zero, filled)
    return torch.where(draws["do_noise"] & (dropped > 0.0), dropped + draws["gauss"], dropped)


def bilateral_depth_smooth(depth: torch.Tensor, radius: int = 2, sigma_space: float = 1.5,
                           sigma_depth: float = 0.01) -> torch.Tensor:
    """Edge-preserving bilateral smoothing of (B, H, W) depth (reference
    depth_image_smoothing.py bilateral_filter), with wrap-around shifts as
    the JAX package rolls. Zero pixels stay zero and contribute nothing."""
    valid = (depth > 1e-6).to(depth.dtype)
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(depth, (dy, dx), dims=(1, 2))
            vs = torch.roll(valid, (dy, dx), dims=(1, 2))
            w_s = math.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2))
            w_d = torch.exp(-torch.square(shifted - depth) / (2 * sigma_depth ** 2))
            w = w_s * w_d * vs
            acc = acc + w * shifted
            wacc = wacc + w
    out = acc / torch.clamp_min(wacc, 1e-9)
    return torch.where(valid > 0, out, torch.zeros_like(out))
