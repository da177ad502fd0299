"""Weight bridges for the port's reference-named ``state_dict``.

``state_dict_from_flax`` turns the JAX package's GDRN parameter tree (numpy
arrays) into the port's state dict. It is the inverse of
``gdrnpp_bop2022_tpu/utils/torch_port.py::convert_gdrn_checkpoint``, so
both packages can be made to compute the same function.
``yolox_state_dict_from_flax`` does the same for YOLOX (GN or BN); for BN it
is the inverse of ``convert_yolox_checkpoint``.

``seeded_state_dict`` draws a full state dict from a numpy seed, at a scale
where every layer matters (layer scale and out-conv inits of 1e-6..1e-2
would make most of the network a no-op).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..models.gdrn import xyz_mask_region_out_dims
from ..models.heads.conv_pnp_net import final_spatial
from .channel_perm import focus_input_perm, geo_out_channel_perm

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
    out = {f"{prefix}.{k}": torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for prefix, sd in parts.items() for k, v in sd.items()}
    # loss.use_mtl's learned log-variances: top-level scalars of one name
    # in both trees
    out.update({k: torch.from_numpy(np.asarray(v, np.float32).copy())
                for k, v in params.items() if k.startswith("log_var_")})
    return out


# YOLOX: the JAX package's module names -> the reference's (torch_port.py's
# convert_yolox_checkpoint name map, inverted)
_YOLOX_PAFPN = {"lateral5": "lateral_conv0", "fpn_c4": "C3_p4", "lateral4": "reduce_conv1",
                "fpn_c3": "C3_p3", "down3": "bu_conv2", "pan_c4": "C3_n3",
                "down4": "bu_conv1", "pan_c5": "C3_n4"}
_YOLOX_DARK = {"stem": "stem.conv", "dark5_spp": "dark5.1", "dark5_csp": "dark5.2",
               **{f"dark{n}_conv": f"dark{n}.0" for n in range(2, 6)},
               **{f"dark{n}_csp": f"dark{n}.1" for n in range(2, 5)}}


def _yolox_head_name(name: str) -> str:
    m = re.fullmatch(r"(stem|cls_pred|reg_pred|obj_pred)(\d+)", name)
    if m:
        return f"{m[1]}s.{m[2]}"
    m = re.fullmatch(r"(cls|reg)(\d+)_(\d+)", name)
    if m:
        return f"{m[1]}_convs.{m[2]}.{m[3]}"
    raise KeyError(f"unknown YOLOX head module {name!r}")


def _yolox_node(p, s, prefix, out):
    """One flax subtree -> reference-named entries: a conv + norm node
    (BaseConv), a plain conv (the head's predictions), or a container whose
    children keep their names (``m{i}`` -> ``m.{i}``)."""
    if "Conv_0" in p:
        out[f"{prefix}.conv.weight"] = _conv(p["Conv_0"]["kernel"])
        norm = "BatchNorm_0" if "BatchNorm_0" in p else "GroupNorm_0"
        out[f"{prefix}.bn.weight"] = np.asarray(p[norm]["scale"])
        out[f"{prefix}.bn.bias"] = np.asarray(p[norm]["bias"])
        if norm == "BatchNorm_0":
            if s is None or "BatchNorm_0" not in s:
                raise ValueError(f"{prefix}: a BN model needs its batch_stats")
            out[f"{prefix}.bn.running_mean"] = np.asarray(s["BatchNorm_0"]["mean"])
            out[f"{prefix}.bn.running_var"] = np.asarray(s["BatchNorm_0"]["var"])
            out[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    elif "kernel" in p:
        out[f"{prefix}.weight"] = _conv(p["kernel"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    else:
        for name, child in p.items():
            sub = f"m.{name[1:]}" if name[0] == "m" and name[1:].isdigit() else name
            _yolox_node(child, None if s is None else s.get(name), f"{prefix}.{sub}", out)


def yolox_state_dict_from_flax(params: dict, batch_stats: dict = None) -> Dict[str, torch.Tensor]:
    """JAX YOLOX params (and, for ``norm="BN"``, its batch_stats) -> the
    port's state dict in the reference's names (``backbone.backbone.stem.
    conv.*``, ``backbone.lateral_conv0.*``, ``head.stems.0.*``, ...). The
    stem conv's input channels go from the JAX package's Focus order to the
    reference's. A reference ``.pth`` needs no bridge: it loads as it is."""
    stats = batch_stats or {}
    out: Dict[str, np.ndarray] = {}
    pafpn, s_pafpn = params["pafpn"], stats.get("pafpn", {})
    for name, node in pafpn["backbone"].items():
        _yolox_node(node, s_pafpn.get("backbone", {}).get(name),
                    f"backbone.backbone.{_YOLOX_DARK[name]}", out)
    for name, node in pafpn.items():
        if name != "backbone":
            _yolox_node(node, s_pafpn.get(name), f"backbone.{_YOLOX_PAFPN[name]}", out)
    for name, node in params["head"].items():
        _yolox_node(node, stats.get("head", {}).get(name), f"head.{_yolox_head_name(name)}", out)
    w = out["backbone.backbone.stem.conv.conv.weight"]
    w_ref = np.empty_like(w)
    w_ref[:, focus_input_perm(w.shape[1] // 4)] = w      # jax[i] = ref[perm[i]]
    out["backbone.backbone.stem.conv.conv.weight"] = w_ref
    return {k: torch.from_numpy(np.array(v, np.int64 if v.dtype == np.int64 else np.float32,
                                         order="C"))
            for k, v in out.items()}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` drawn from ``np.random.RandomState(seed)``:
    weights N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N, layer
    scales U(0.1, 0.5); BatchNorm running means 0.1 N and variances
    U(0.5, 2). The same seed gives the same weights on any device."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        if name.endswith("running_var"):
            v = rs.uniform(0.5, 2.0, shape)
        elif name.endswith("gamma"):
            v = rs.uniform(0.1, 0.5, shape)
        elif len(shape) == 1 and name.endswith("weight"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            v = 0.1 * rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out
