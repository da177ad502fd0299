"""Stochastic colour augmentation and background replacement, batched on
the images' device.

Port of ``gdrnpp_bop2022_tpu/ops/color_aug.py`` (the reference's imgaug
pipelines, configs/gdrn/ycbv/...ycbv.py:11-31, base_data_loader.py:233-460).
Every augmentation is split in two:

  * ``draw_*(gen, ...)`` draws every random number the augmentation uses
    from an explicit ``torch.Generator`` (on the device the draws go to)
    and returns them as a dict of tensors: per-sample gates in {0, 1},
    per-sample (or per-channel) parameters, and the dense fields (coarse
    dropout grids, noise);
  * the augmentation itself is a pure function of the images and the
    draws.

So a test can feed the port the draws the JAX package makes from its keys,
and the two agree to rounding; the trainer draws from one generator per
purpose. No global RNG is used. Images are (B, H, W, 3) channels-last in
[0, 255]; gates and parameters broadcast as (B, 1, 1, 1) or (B, 1, 1, 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .color_space import hsv_to_rgb, rgb_to_hsv


# -- draws ---------------------------------------------------------------------

def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen, p, *shape):
    """{0, 1} float32, 1 with probability p (u < p, as jax.random.bernoulli)."""
    return (_rand(gen, *shape) < p).float()


def _uniform(gen, B, lo, hi, per_channel_p=0.0):
    """(B, 1) per-sample U(lo, hi), or (B, 3) where a per-sample coin with
    probability per_channel_p picks per-channel values."""
    v = lo + (hi - lo) * _rand(gen, B, 1)
    if per_channel_p <= 0:
        return v
    vc = lo + (hi - lo) * _rand(gen, B, 3)
    use_pc = _bernoulli(gen, per_channel_p, B, 1)
    return torch.where(use_pc > 0, vc, v)


def _log_uniform(gen, B, lo, hi):
    return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * _rand(gen, B))


def _dropout_grid(gen, H, W, B, p_drop=0.2, size_percent=0.05):
    gh, gw = max(int(H * size_percent), 1), max(int(W * size_percent), 1)
    return _bernoulli(gen, p_drop, B, gh, gw)


def draw_cosy_aae(gen: torch.Generator, shape, global_prob: float = 0.8) -> dict:
    """The draws of ``cosy_aae_color_aug`` for images of ``shape`` (B, H, W,
    3): the pipeline's gate ``applied`` (p = global_prob) and, per op, its
    gate and parameters."""
    B, H, W, _ = shape
    d = {"applied": _bernoulli(gen, global_prob, B)}
    d["drop_gate"], d["drop_mask"] = _bernoulli(gen, 0.5, B), _dropout_grid(gen, H, W, B)
    d["blur_gate"], d["blur_strength"] = _bernoulli(gen, 0.4, B), _rand(gen, B)
    d["sharp_gate"], d["sharp_f"] = _bernoulli(gen, 0.3, B), 50.0 * _rand(gen, B)
    d["contrast_gate"], d["contrast_f"] = _bernoulli(gen, 0.3, B), _log_uniform(gen, B, 0.2, 5.0)
    d["bright_gate"], d["bright_f"] = _bernoulli(gen, 0.5, B), _log_uniform(gen, B, 0.1, 6.0)
    d["color_gate"], d["color_f"] = _bernoulli(gen, 0.3, B), _log_uniform(gen, B, 0.05, 20.0)
    d["add_gate"], d["add"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, -25.0, 25.0, 0.3)
    d["invert_gate"], d["invert"] = _bernoulli(gen, 0.3, B), _bernoulli(gen, 0.2, B, 3)
    d["mul_pc_gate"], d["mul_pc"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.6, 1.4, 0.5)
    d["mul_gate"], d["mul"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.6, 1.4)
    d["noise_gate"] = _bernoulli(gen, 0.1, B)
    d["noise"] = 10.0 * torch.randn((B, H, W, 3), generator=gen, device=gen.device)
    d["lc_gate"], d["lc"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.5, 2.2, 0.3)
    d["gray_gate"], d["gray_alpha"] = _bernoulli(gen, 0.5, B), _rand(gen, B)
    return d


def draw_aae(gen: torch.Generator, shape) -> dict:
    """The draws of ``aae_color_aug``."""
    B, H, W, _ = shape
    d = {"drop_gate": _bernoulli(gen, 0.5, B), "drop_mask": _dropout_grid(gen, H, W, B)}
    d["blur_gate"], d["blur_strength"] = _bernoulli(gen, 0.5, B), _rand(gen, B)
    d["add_gate"], d["add"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, -25.0, 25.0, 0.3)
    d["invert_gate"], d["invert"] = _bernoulli(gen, 0.3, B), _bernoulli(gen, 0.2, B, 3)
    d["mul_pc_gate"], d["mul_pc"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.6, 1.4, 0.5)
    d["mul_gate"], d["mul"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.6, 1.4)
    d["lc_gate"], d["lc"] = _bernoulli(gen, 0.5, B), _uniform(gen, B, 0.5, 2.2, 0.3)
    return d


def draw_ssd(gen: torch.Generator, shape, brightness_delta: float = 32.0,
             contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
             hue_delta: float = 18.0) -> dict:
    """The draws of ``ssd_color_aug``: four per-sample parameters, each
    with a gate of p = 0.5."""
    B = shape[0]
    u = lambda lo, hi: lo + (hi - lo) * _rand(gen, B)      # noqa: E731
    return {"brightness": u(-brightness_delta, brightness_delta),
            "brightness_gate": _bernoulli(gen, 0.5, B),
            "contrast": u(*contrast_range), "contrast_gate": _bernoulli(gen, 0.5, B),
            "saturation": u(*saturation_range), "saturation_gate": _bernoulli(gen, 0.5, B),
            "hue": u(-hue_delta, hue_delta), "hue_gate": _bernoulli(gen, 0.5, B)}


def draw_roi10d(gen: torch.Generator, shape, brightness_delta: float = 2.5 / 255.0,
                lighting_std: float = 0.3, saturation_var=(0.95, 1.05),
                contrast_var=(0.95, 1.05)) -> dict:
    """The draws of ``roi10d_color_aug`` (each part always applied)."""
    B = shape[0]
    u = lambda lo, hi: lo + (hi - lo) * _rand(gen, B)      # noqa: E731
    return {"brightness": u(-brightness_delta, brightness_delta),
            "lighting": lighting_std * torch.randn((B, 3), generator=gen, device=gen.device),
            "saturation": u(*saturation_var), "contrast": u(*contrast_var)}


def draw_replace_background(gen: torch.Generator, batch: int, num_bg: int,
                            prob: float = 0.5) -> dict:
    """Which of the num_bg backgrounds each sample takes, and whether its
    background is replaced (p = prob)."""
    return {"bg_idx": torch.randint(0, num_bg, (batch,), generator=gen, device=gen.device),
            "use": _bernoulli(gen, prob, batch)}


# -- the augmentations, pure functions of images and draws ---------------------------

def _b(v: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, C) -> (B, 1, 1, 1) or (B, 1, 1, C)."""
    return v.reshape(v.shape[0], 1, 1, -1)


def _blend(x, aug, gate):
    return x * (1.0 - gate) + aug * gate


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) BT.601 luma, broadcast against x."""
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def _blur3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box blur with edge padding, summed in the JAX package's order."""
    H, W = x.shape[1], x.shape[2]
    p = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    acc = None
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            s = p[:, :, dy:dy + H, dx:dx + W]
            acc = s if acc is None else acc + s
    return (acc / 9.0).permute(0, 2, 3, 1)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image.resize's nearest source index: floor((i + 0.5) * n_in / n_out)."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long().clamp_max(n_in - 1)


def _coarse_dropout(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x * (1 - the (B, gh, gw) drop grid resized to (H, W), nearest)."""
    H, W = x.shape[1], x.shape[2]
    iy = _nearest_index(grid.shape[1], H, x.device)
    ix = _nearest_index(grid.shape[2], W, x.device)
    drop = grid.to(x.dtype)[:, iy][:, :, ix][..., None]
    return x * (1.0 - drop)


def _add_invert_mul(x, d):
    """Add, Invert, Multiply (per channel), Multiply: the ops the cosy+aae
    and aae pipelines share, in their order."""
    x = _blend(x, x + _b(d["add"]), _b(d["add_gate"]))
    inv = _b(d["invert"])
    x = _blend(x, x * (1 - inv) + (255.0 - x) * inv, _b(d["invert_gate"]))
    x = _blend(x, x * _b(d["mul_pc"]), _b(d["mul_pc_gate"]))
    return _blend(x, x * _b(d["mul"]), _b(d["mul_gate"]))


def _linear_contrast(x, d):
    return _blend(x, 127.5 + _b(d["lc"]) * (x - 127.5), _b(d["lc_gate"]))


def cosy_aae_color_aug(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """The BOP'22 "cosy+aae" pipeline on (B, H, W, 3) images in [0, 255]:
    13 gated ops in a fixed order, clipped, then the whole pipeline gated
    per sample by ``applied``. Returns float32 in [0, 255]."""
    d = draws
    x = images.float()
    orig = x
    x = _blend(x, _coarse_dropout(x, d["drop_mask"]), _b(d["drop_gate"]))
    # GaussianBlur((0, 3)): a strength-blended 3x3 blur, twice at the strong end
    s = _b(d["blur_strength"])
    blurred = _blur3(x)
    bl = x * (1 - s) + torch.where(s > 0.5, _blur3(blurred), blurred) * s
    x = _blend(x, bl, _b(d["blur_gate"]))
    # EnhanceSharpness: blur + f (x - blur)
    blurred = _blur3(x)
    x = _blend(x, blurred + _b(d["sharp_f"]) * (x - blurred), _b(d["sharp_gate"]))
    # EnhanceContrast: against the mean gray
    mean = _grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
    x = _blend(x, mean + _b(d["contrast_f"]) * (x - mean), _b(d["contrast_gate"]))
    x = _blend(x, x * _b(d["bright_f"]), _b(d["bright_gate"]))
    gray = _grayscale(x)
    x = _blend(x, gray + _b(d["color_f"]) * (x - gray), _b(d["color_gate"]))
    x = _add_invert_mul(x, d)
    x = _blend(x, x + d["noise"], _b(d["noise_gate"]))
    x = _linear_contrast(x, d)
    a = _b(d["gray_alpha"])
    x = _blend(x, x * (1 - a) + _grayscale(x) * a, _b(d["gray_gate"]))
    x = x.clamp(0.0, 255.0)
    applied = _b(d["applied"])
    return orig * (1 - applied) + x * applied


def aae_color_aug(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """The AAE pipeline: CoarseDropout, GaussianBlur, Add, Invert, 2x
    Multiply, LinearContrast. [0, 255] -> float32 in [0, 255]."""
    d = draws
    x = images.float()
    x = _blend(x, _coarse_dropout(x, d["drop_mask"]), _b(d["drop_gate"]))
    s = _b(d["blur_strength"])
    x = _blend(x, x * (1 - s) + _blur3(x) * s, _b(d["blur_gate"]))
    x = _add_invert_mul(x, d)
    return _linear_contrast(x, d).clamp(0.0, 255.0)


def ssd_color_aug(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """SSD photometric distortion (brightness shift, contrast scale, HSV
    saturation scale, hue roll; hue_delta in degrees of 180 maps to
    radians as delta / 180 * 2pi). Returns the images' dtype."""
    d = draws
    x = images.float()
    x = (x + _b(d["brightness"]) * _b(d["brightness_gate"])).clamp(0, 255)
    g = _b(d["contrast_gate"])
    x = (x * (_b(d["contrast"]) * g + (1.0 - g))).clamp(0, 255)
    hsv = rgb_to_hsv(x / 255.0)
    gs = _b(d["saturation_gate"])[..., 0]
    sat = (hsv[..., 1] * (_b(d["saturation"])[..., 0] * gs + (1.0 - gs))).clamp(0.0, 1.0)
    gh = _b(d["hue_gate"])[..., 0]
    two_pi = 2.0 * math.pi
    hue = torch.remainder(hsv[..., 0] + _b(d["hue"])[..., 0] * gh / 180.0 * two_pi, two_pi)
    x = hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1)) * 255.0
    return x.clamp(0, 255).to(images.dtype)


def roi10d_color_aug(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """ROI10D's AugmentRGB in [0, 1]: brightness shift, PCA lighting noise
    along each image's RGB covariance eigenbasis, saturation and contrast.
    Returns float32 in [0, 255]."""
    d = draws
    x = images.float() / 255.0
    B = x.shape[0]
    x = x + _b(d["brightness"])
    flat = x.reshape(B, -1, 3)
    cen = flat - flat.mean(dim=1, keepdim=True)
    cov = torch.einsum("bnc,bnd->bcd", cen, cen) / flat.shape[1]
    eigval, eigvec = torch.linalg.eigh(cov)
    delta = torch.einsum("bcd,bd->bc", eigvec, eigval * d["lighting"])
    x = x + delta[:, None, None, :]
    gs = _grayscale(x)
    x = gs + _b(d["saturation"]) * (x - gs)
    mean = gs.mean(dim=(1, 2, 3), keepdim=True)
    x = mean + _b(d["contrast"]) * (x - mean)
    return x.clamp(0.0, 1.0) * 255.0


def replace_background(images: torch.Tensor, fg_masks: torch.Tensor,
                       bg_images: torch.Tensor, draws: dict):
    """Swap the pixels outside each foreground mask with a background
    image (reference replace_bg, base_data_loader.py:413-460).

    images (B, H, W, 3), fg_masks (B, H, W), bg_images (N, H, W, 3); draws
    of ``draw_replace_background``. Returns (images, gate (B,)): the gate
    tells which samples were composited, so the trainer can tie the
    foreground truncation's supervision to them."""
    bgs = bg_images[draws["bg_idx"]].to(images.dtype)
    use = _b(draws["use"]).to(images.dtype)
    fg = fg_masks[..., None].to(images.dtype)
    swapped = images * fg + bgs * (1.0 - fg)
    return images * (1 - use) + swapped * use, draws["use"]


# preset -> (draw, augmentation) (reference aug_type switch,
# base_data_loader.py:233-321)
PRESETS = {
    "cosy+aae": (draw_cosy_aae, cosy_aae_color_aug),
    "cosy_aae": (draw_cosy_aae, cosy_aae_color_aug),
    "aae": (draw_aae, aae_color_aug),
    "roi10d": (draw_roi10d, roi10d_color_aug),
    "ssd": (draw_ssd, ssd_color_aug),
}


def color_aug_by_type(aug_type: str):
    """(draw, augmentation) of a preset."""
    t = aug_type.lower()
    if t not in PRESETS:
        raise ValueError(f"unknown color aug type {aug_type!r}; expected one of "
                         f"{sorted(PRESETS)}")
    return PRESETS[t]


def _is_cosy(aug_type: str) -> bool:
    return aug_type.lower() in ("cosy+aae", "cosy_aae")


def draw_color_aug(gen: torch.Generator, shape, aug_type: str, prob: float) -> dict:
    """The trainer's colour augmentation draws: cosy+aae takes ``prob`` as
    its own gate; every other preset is gated per sample by ``prob`` around
    its own per-op gates (``gate``, then the preset's draws under ``aug``)."""
    draw, _ = color_aug_by_type(aug_type)
    if _is_cosy(aug_type):
        return draw(gen, shape, global_prob=prob)
    return {"gate": _bernoulli(gen, prob, shape[0]), "aug": draw(gen, shape)}


def apply_color_aug(images: torch.Tensor, draws: dict, aug_type: str) -> torch.Tensor:
    """The trainer's colour augmentation of ``draw_color_aug``'s draws
    (JAX engine/trainer.py:245-260; the reference applies COLOR_AUG_PROB
    the same way, data_loader.py:381-390). Returns float32."""
    _, aug = color_aug_by_type(aug_type)
    if _is_cosy(aug_type):
        return aug(images, draws)
    gate = _b(draws["gate"])
    return images.float() * (1 - gate) + aug(images, draws["aug"]).float() * gate
