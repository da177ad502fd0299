"""Batched colour-space conversions, channels-last, float in [0, 1].

Port of ``gdrnpp_bop2022_tpu/ops/color_space.py`` (reference
lib/torch_utils/color/{gray,hsv,hls,lab,luv,xyz,ycbcr,yuv,rgb}.py). Hue is
in radians [0, 2pi); Lab and Luv use the D65 white point with sRGB
linearisation; luma weights are BT.601. Every function takes and returns
(..., 3) tensors, so it works on (B, H, W, 3) images and on pixel lists.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


# -- gray / channel order ----------------------------------------------------

def rgb_to_grayscale(image: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """BT.601 luma. Returns (..., 1) by default."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
    g = torch.tensordot(image, w, dims=([-1], [0]))
    return g[..., None] if keepdims else g


def bgr_to_grayscale(image: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return rgb_to_grayscale(image.flip(-1), keepdims=keepdims)


def rgb_to_bgr(image: torch.Tensor) -> torch.Tensor:
    return image.flip(-1)


bgr_to_rgb = rgb_to_bgr


def rgb_to_rgba(image: torch.Tensor, alpha_val: float = 1.0) -> torch.Tensor:
    a = torch.full(image.shape[:-1] + (1,), alpha_val, dtype=image.dtype, device=image.device)
    return torch.cat([image, a], dim=-1)


def rgba_to_rgb(image: torch.Tensor) -> torch.Tensor:
    rgb, a = image[..., :3], image[..., 3:4]
    return rgb * a + (1.0 - a)


# -- HSV / HLS ---------------------------------------------------------------

def rgb_to_hsv(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) rgb -> (h in [0, 2pi), s, v)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    maxc = image.amax(dim=-1)
    minc = image.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = delta / (maxc + eps)
    dd = delta + eps
    rc = (maxc - r) / dd
    gc = (maxc - g) / dd
    bc = (maxc - b) / dd
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta <= eps, torch.zeros_like(h), h)
    h = torch.remainder(h / 6.0, 1.0) * _TWO_PI
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hsv."""
    h = torch.remainder(image[..., 0] / _TWO_PI, 1.0)
    s, v = image[..., 1], image[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    idx = torch.remainder(i, 6.0).long()
    by_case = torch.stack([
        torch.stack([v, t, p], dim=-1), torch.stack([q, v, p], dim=-1),
        torch.stack([p, v, t], dim=-1), torch.stack([p, q, v], dim=-1),
        torch.stack([t, p, v], dim=-1), torch.stack([v, p, q], dim=-1)], dim=-2)
    idx = idx[..., None, None].expand(*idx.shape, 1, 3)
    return torch.gather(by_case, -2, idx)[..., 0, :]


def rgb_to_hls(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) rgb -> (h in [0, 2pi), l, s)."""
    maxc = image.amax(dim=-1)
    minc = image.amin(dim=-1)
    l = (maxc + minc) * 0.5                                           # noqa: E741
    delta = maxc - minc
    s = torch.where(l < 0.5, delta / (maxc + minc + eps),
                    delta / torch.clamp_min(2.0 - maxc - minc, eps))
    s = torch.where(delta <= eps, torch.zeros_like(s), s)
    h = rgb_to_hsv(image, eps=eps)[..., 0]
    return torch.stack([h, l, s], dim=-1)


def hls_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_hls."""
    h, l, s = image[..., 0], image[..., 1], image[..., 2]             # noqa: E741
    v = torch.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    sv = torch.where(v > 0, 2.0 - 2.0 * l / torch.clamp_min(v, 1e-12), torch.zeros_like(v))
    return hsv_to_rgb(torch.stack([h, sv, v], dim=-1))


# -- linear RGB / XYZ / Lab / Luv ---------------------------------------------

def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.04045, torch.pow((c + 0.055) / 1.055, 2.4), c / 12.92)


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.0031308,
                       1.055 * torch.pow(torch.clamp_min(c, 1e-12), 1.0 / 2.4) - 0.055,
                       12.92 * c)


_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))
_D65 = (0.95047, 1.0, 1.08883)


def _mat3(image: torch.Tensor, m) -> torch.Tensor:
    """(..., 3) @ m^T in the image's dtype."""
    mt = torch.tensor(m, dtype=image.dtype, device=image.device)
    return torch.einsum("...c,kc->...k", image, mt)


def rgb_to_xyz(image: torch.Tensor) -> torch.Tensor:
    """Linear transform, no gamma."""
    return _mat3(image, _RGB2XYZ)


def xyz_to_rgb(image: torch.Tensor) -> torch.Tensor:
    return _mat3(image, _XYZ2RGB)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Cube root of a positive tensor."""
    return torch.pow(t, 1.0 / 3.0)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    d3 = (6.0 / 29.0) ** 3
    return torch.where(t > d3, _cbrt(torch.clamp_min(t, 1e-12)),
                       t / (3.0 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)


def _lab_finv(t: torch.Tensor) -> torch.Tensor:
    d = 6.0 / 29.0
    return torch.where(t > d, t ** 3, 3.0 * d * d * (t - 4.0 / 29.0))


def rgb_to_lab(image: torch.Tensor) -> torch.Tensor:
    """sRGB -> CIE Lab, D65. L in [0, 100], a/b roughly [-128, 127]."""
    xyz = rgb_to_xyz(_srgb_to_linear(image))
    xn = torch.tensor(_D65, dtype=image.dtype, device=image.device)
    f = _lab_f(xyz / xn)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def lab_to_rgb(image: torch.Tensor, clip: bool = True) -> torch.Tensor:
    """Inverse of rgb_to_lab."""
    L, a, b = image[..., 0], image[..., 1], image[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    xn = torch.tensor(_D65, dtype=image.dtype, device=image.device)
    xyz = torch.stack([_lab_finv(fx), _lab_finv(fy), _lab_finv(fz)], dim=-1) * xn
    rgb = _linear_to_srgb(xyz_to_rgb(xyz))
    return rgb.clamp(0.0, 1.0) if clip else rgb


def normalize_lab(lab: torch.Tensor) -> torch.Tensor:
    """Lab scaled to ~[0, 1] / [-1, 1] network inputs."""
    return lab / torch.tensor([100.0, 127.0, 127.0], dtype=lab.dtype, device=lab.device)


def denormalize_lab(lab_normed: torch.Tensor) -> torch.Tensor:
    return lab_normed * torch.tensor([100.0, 127.0, 127.0], dtype=lab_normed.dtype,
                                     device=lab_normed.device)


def _uv_white():
    xn, yn, zn = _D65
    return (4.0 * xn / (xn + 15.0 * yn + 3.0 * zn), 9.0 * yn / (xn + 15.0 * yn + 3.0 * zn))


def rgb_to_luv(image: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """sRGB -> CIE Luv, D65."""
    xyz = rgb_to_xyz(_srgb_to_linear(image))
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    threshold = (6.0 / 29.0) ** 3
    L = torch.where(y > threshold, 116.0 * _cbrt(torch.clamp_min(y, eps)) - 16.0,
                    (29.0 / 3.0) ** 3 * y)
    denom = x + 15.0 * y + 3.0 * z + eps
    u_p = 4.0 * x / denom
    v_p = 9.0 * y / denom
    un, vn = _uv_white()
    return torch.stack([L, 13.0 * L * (u_p - un), 13.0 * L * (v_p - vn)], dim=-1)


def luv_to_rgb(image: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Inverse of rgb_to_luv."""
    L, u, v = image[..., 0], image[..., 1], image[..., 2]
    yn = _D65[1]
    un, vn = _uv_white()
    u_p = u / torch.clamp_min(13.0 * L, eps) + un
    v_p = v / torch.clamp_min(13.0 * L, eps) + vn
    y = torch.where(L > 8.0, yn * ((L + 16.0) / 116.0) ** 3, yn * L * (3.0 / 29.0) ** 3)
    x = y * 9.0 * u_p / torch.clamp_min(4.0 * v_p, eps)
    z = y * (12.0 - 3.0 * u_p - 20.0 * v_p) / torch.clamp_min(4.0 * v_p, eps)
    rgb = _linear_to_srgb(xyz_to_rgb(torch.stack([x, y, z], dim=-1)))
    return rgb.clamp(0.0, 1.0)


# -- YCbCr / YUV ---------------------------------------------------------------

def rgb_to_ycbcr(image: torch.Tensor) -> torch.Tensor:
    """BT.601 full range."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return torch.stack([y, (b - y) * 0.564 + 0.5, (r - y) * 0.713 + 0.5], dim=-1)


def ycbcr_to_rgb(image: torch.Tensor) -> torch.Tensor:
    y, cb, cr = image[..., 0], image[..., 1] - 0.5, image[..., 2] - 0.5
    return torch.stack([y + 1.403 * cr, y - 0.714 * cr - 0.344 * cb, y + 1.773 * cb], dim=-1)


def rgb_to_yuv(image: torch.Tensor) -> torch.Tensor:
    """BT.601 YUV."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return torch.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.147 * r - 0.289 * g + 0.436 * b,
                        0.615 * r - 0.515 * g - 0.100 * b], dim=-1)


def yuv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    y, u, v = image[..., 0], image[..., 1], image[..., 2]
    return torch.stack([y + 1.14 * v, y - 0.396 * u - 0.581 * v, y + 2.029 * u], dim=-1)
