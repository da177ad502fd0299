"""Weight bridges for the port's reference-named ``state_dict``.

``state_dict_from_flax`` turns the JAX package's GDRN parameter tree (numpy
arrays) into the port's state dict. It is the inverse of
``gdrnpp_bop2022_tpu/utils/torch_port.py::convert_gdrn_checkpoint``, so
both packages can be made to compute the same function.

``seeded_state_dict`` draws a full state dict from a numpy seed, at a scale
where every layer matters (layer scale and out-conv inits of 1e-6..1e-2
would make most of the network a no-op).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..models.gdrn import xyz_mask_region_out_dims
from ..models.heads.conv_pnp_net import final_spatial
from .channel_perm import geo_out_channel_perm

_CONVNEXT_DEPTHS = {"convnext_tiny": (3, 3, 9, 3),
                    "convnext_small": (3, 3, 27, 3),
                    "convnext_base": (3, 3, 27, 3)}


def _conv(k):
    """flax (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _conv_transpose(k):
    """flax ConvTranspose (kh, kw, I, O) -> torch (I, O, kh, kw), unflipped."""
    return np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1))


def _linear(k):
    return np.transpose(np.asarray(k), (1, 0))


def _ln(node):
    return np.asarray(node["LayerNorm_0"]["scale"]), np.asarray(node["LayerNorm_0"]["bias"])


def _gn(node):
    g = node["GroupNorm32_0"]["GroupNorm_0"]
    return np.asarray(g["scale"]), np.asarray(g["bias"])


def _convnext(p, depths) -> Dict[str, np.ndarray]:
    sd = {"stem.0.weight": _conv(p["stem_conv"]["kernel"]),
          "stem.0.bias": np.asarray(p["stem_conv"]["bias"])}
    sd["stem.1.weight"], sd["stem.1.bias"] = _ln(p["stem_norm"])
    for s in range(4):
        if s > 0:
            d = f"stages.{s}.downsample"
            sd[f"{d}.0.weight"], sd[f"{d}.0.bias"] = _ln(p[f"downsample_norm{s}"])
            sd[f"{d}.1.weight"] = _conv(p[f"downsample_conv{s}"]["kernel"])
            sd[f"{d}.1.bias"] = np.asarray(p[f"downsample_conv{s}"]["bias"])
        for b in range(depths[s]):
            q, n = p[f"stage{s}_block{b}"], f"stages.{s}.blocks.{b}"
            sd[f"{n}.conv_dw.weight"] = _conv(q["dwconv"]["kernel"])
            sd[f"{n}.conv_dw.bias"] = np.asarray(q["dwconv"]["bias"])
            sd[f"{n}.norm.weight"], sd[f"{n}.norm.bias"] = _ln(q["norm"])
            for fc, src in (("fc1", "pwconv1"), ("fc2", "pwconv2")):
                sd[f"{n}.mlp.{fc}.weight"] = _linear(q[src]["kernel"])
                sd[f"{n}.mlp.{fc}.bias"] = np.asarray(q[src]["bias"])
            sd[f"{n}.gamma"] = np.asarray(q["gamma"])
    return sd


def _geo_head(p, gh, dims, nc) -> Dict[str, np.ndarray]:
    xyz_dim, mask_dim, region_dim = dims
    sd, idx = {}, 0
    for i, up in enumerate(gh.up_types):
        blk = p[f"up{i}"]
        if up == "deconv":
            sd[f"features.{idx}.weight"] = _conv_transpose(blk["deconv"]["kernel"])
            sd[f"features.{idx + 1}.weight"], sd[f"features.{idx + 1}.bias"] = _gn(blk)
            idx += 3
        else:
            idx += 1
        for j in range(gh.num_conv_per_block):
            sd[f"features.{idx}.conv.weight"] = _conv(blk[f"conv{j}"]["Conv_0"]["kernel"])
            sd[f"features.{idx}.gn.weight"], sd[f"features.{idx}.gn.bias"] = \
                _gn(blk[f"conv{j}"])
            idx += 1
    perm = geo_out_channel_perm(mask_dim, xyz_dim, region_dim,
                                nc if gh.mask_class_aware else 1,
                                nc if gh.xyz_class_aware else 1,
                                nc if gh.region_class_aware else 1)
    w = _conv(p["out_conv_kernel"])                  # (total, I, k, k), JAX order
    b = np.asarray(p["out_conv_bias"])
    w_ref, b_ref = np.empty_like(w), np.empty_like(b)
    w_ref[perm], b_ref[perm] = w, b                  # jax[i] = ref[perm[i]]
    sd["out_layer.weight"], sd["out_layer.bias"] = w_ref, b_ref
    return sd


def _pnp_net(p, pn, output_res) -> Dict[str, np.ndarray]:
    names = ([f"conv_s2_{i}" for i in range(pn.num_stride2_layers)]
             + [f"conv_extra_{i}" for i in range(pn.num_extra_layers)])
    sd = {}
    for li, name in enumerate(names):
        ci = 3 * li
        sd[f"features.{ci}.weight"] = _conv(p[name]["Conv_0"]["kernel"])
        sd[f"features.{ci + 1}.weight"], sd[f"features.{ci + 1}.bias"] = _gn(p[name])
    w1 = _linear(p["fc1"]["kernel"])                  # (1024, fc_in), NHWC flatten
    if pn.flat_op == "flatten":
        s = final_spatial(output_res, pn.num_stride2_layers)
        w1 = (w1.reshape(w1.shape[0], s, s, pn.featdim).transpose(0, 3, 1, 2)
              .reshape(w1.shape[0], -1))              # -> NCHW flatten
    sd["fc1.weight"], sd["fc1.bias"] = w1, np.asarray(p["fc1"]["bias"])
    for fc in ("fc2", "fc_r", "fc_t"):
        sd[f"{fc}.weight"] = _linear(p[fc]["kernel"])
        sd[f"{fc}.bias"] = np.asarray(p[fc]["bias"])
    return sd


def state_dict_from_flax(params: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX GDRN params (nested dict of arrays) -> the port's state dict."""
    pc = cfg.model.pose_net
    if pc.backbone.name not in _CONVNEXT_DEPTHS:
        raise NotImplementedError(f"backbone {pc.backbone.name!r}")
    depths = _CONVNEXT_DEPTHS[pc.backbone.name]
    parts = {
        "backbone": _convnext(params["backbone"], depths),
        "geo_head_net": _geo_head(params["geo_head"], pc.geo_head,
                                  xyz_mask_region_out_dims(pc), pc.num_classes),
        "pnp_net": _pnp_net(params["pnp_net"], pc.pnp_net, pc.output_res),
    }
    if "depth_backbone" in params:          # the RGB-D dual-stream variant
        parts["depth_backbone"] = _convnext(params["depth_backbone"], depths)
    return {f"{prefix}.{k}": torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for prefix, sd in parts.items() for k, v in sd.items()}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` drawn from ``np.random.RandomState(seed)``:
    weights N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N, layer
    scales U(0.1, 0.5). The same seed gives the same weights on any device."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("gamma"):
            v = rs.uniform(0.1, 0.5, shape)
        elif len(shape) == 1 and name.endswith("weight"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            v = 0.1 * rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out
