"""Weight bridges for the port's reference-named ``state_dict``.

``state_dict_from_flax`` turns the JAX package's GDRN parameter tree (numpy
arrays) into the port's state dict, for every backbone, geo head, PnP net
and fusion the JAX GDRN builds. For the ConvNeXt double-mask model it is
the inverse of ``gdrnpp_bop2022_tpu/utils/torch_port.py::
convert_gdrn_checkpoint``, so both packages can be made to compute the same
function.
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
from ..models.gdrn import _HEADS, xyz_mask_region_out_dims
from ..models.heads.conv_pnp_net import final_spatial
from .channel_perm import focus_input_perm, geo_out_channel_perm

_CONVNEXT_DEPTHS = {"convnext_tiny": (3, 3, 9, 3),
                    "convnext_small": (3, 3, 27, 3),
                    "convnext_base": (3, 3, 27, 3)}
# name -> (stage sizes, basic block)
_RESNETS = {"resnet34": ((3, 4, 6, 3), True), "resnet50": ((3, 4, 6, 3), False),
            "resnet101": ((3, 4, 23, 3), False), "resnet18_8s": ((2, 2, 2, 2), True),
            "resnet34_8s": ((3, 4, 6, 3), True)}
_RESNESTS = {"resnest50": (3, 4, 6, 3), "resnest101": (3, 4, 23, 3)}


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


def _affine(node, prefix) -> Dict[str, np.ndarray]:
    """A flax norm node ({scale, bias}) as ``prefix.weight`` / ``.bias``."""
    return {f"{prefix}.weight": np.asarray(node["scale"]),
            f"{prefix}.bias": np.asarray(node["bias"])}


def _norm(node, prefix) -> Dict[str, np.ndarray]:
    """The one norm of a flax ConvModule, up-block or PnP layer (GN, LN or
    none) as ``prefix.weight`` / ``.bias``."""
    if "GroupNorm32_0" in node:
        return _affine(node["GroupNorm32_0"]["GroupNorm_0"], prefix)
    if "LayerNorm_0" in node:
        return _affine(node["LayerNorm_0"], prefix)
    return {}


def _conv_module(node, prefix) -> Dict[str, np.ndarray]:
    """A flax ConvModule: ``conv``, the norm ``gn`` and, for act="acon",
    AconC's ``p1``, ``p2``, ``beta``."""
    sd = {f"{prefix}.conv.weight": _conv(node["Conv_0"]["kernel"]),
          **_norm(node, f"{prefix}.gn")}
    for k, v in node.get("acon", {}).items():
        sd[f"{prefix}.acon.{k}"] = np.asarray(v)
    return sd


def _resnet(p, stage_sizes, basic) -> Dict[str, np.ndarray]:
    sd = {"conv1.weight": _conv(p["stem"]["kernel"]),
          **_affine(p["GroupNorm32_0"]["GroupNorm_0"], "bn1")}
    n_conv = 2 if basic else 3
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            q, pre = p[f"stage{i}_block{j}"], f"layer{i + 1}.{j}"
            for k in range(n_conv):
                sd[f"{pre}.conv{k + 1}.weight"] = _conv(q[f"Conv_{k}"]["kernel"])
                sd.update(_affine(q[f"GroupNorm32_{k}"]["GroupNorm_0"], f"{pre}.bn{k + 1}"))
            if f"Conv_{n_conv}" in q:
                sd[f"{pre}.downsample.0.weight"] = _conv(q[f"Conv_{n_conv}"]["kernel"])
                sd.update(_affine(q[f"GroupNorm32_{n_conv}"]["GroupNorm_0"],
                                  f"{pre}.downsample.1"))
    return sd


def _dense(node, prefix) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": _linear(node["kernel"]), f"{prefix}.bias": np.asarray(node["bias"])}


def _resnest(p, stage_sizes) -> Dict[str, np.ndarray]:
    gn = lambda node, prefix: _affine(node["GroupNorm_0"], prefix)   # noqa: E731
    sd = {}
    for i, (conv, norm) in enumerate((("conv1.0", "conv1.1"), ("conv1.3", "conv1.4"),
                                      ("conv1.6", "bn1"))):
        sd[f"{conv}.weight"] = _conv(p[f"stem{i}"]["kernel"])
        sd.update(gn(p[f"stem_norm{i}"], norm))
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            q, pre = p[f"stage{i}_block{j}"], f"layer{i + 1}.{j}"
            sp = q["splat"]
            sd[f"{pre}.conv1.weight"] = _conv(q["conv1"]["kernel"])
            sd.update(gn(q["norm1"], f"{pre}.bn1"))
            sd[f"{pre}.conv2.conv.weight"] = _conv(sp["conv"]["kernel"])
            sd.update(gn(sp["norm0"], f"{pre}.conv2.bn0"))
            sd.update(_dense(sp["fc1"], f"{pre}.conv2.fc1"))
            sd.update(gn(sp["norm1"], f"{pre}.conv2.bn1"))
            sd.update(_dense(sp["fc2"], f"{pre}.conv2.fc2"))
            sd[f"{pre}.conv3.weight"] = _conv(q["conv3"]["kernel"])
            sd.update(gn(q["norm3"], f"{pre}.bn3"))
            if "down_conv" in q:
                sd[f"{pre}.downsample.1.weight"] = _conv(q["down_conv"]["kernel"])
                sd.update(gn(q["down_norm"], f"{pre}.downsample.2"))
    return sd


def _darknet(p) -> Dict[str, np.ndarray]:
    """The JAX ``_CSPDarknetBackbone``'s ``darknet`` subtree in the reference
    names (``stem.conv.*``, ``dark{2-5}.*``), the stem's input channels in
    the reference's Focus order."""
    sd: Dict[str, np.ndarray] = {}
    for name, node in p.items():
        _yolox_node(node, None, _YOLOX_DARK[name], sd)
    _focus_to_ref(sd, "stem.conv.conv.weight")
    return sd


def _focus_to_ref(sd, key):
    """The Focus stem conv's input channels from the JAX order to the reference's."""
    w = sd[key]
    w_ref = np.empty_like(w)
    w_ref[:, focus_input_perm(w.shape[1] // 4)] = w      # jax[i] = ref[perm[i]]
    sd[key] = w_ref


def _backbone(p, name) -> Dict[str, np.ndarray]:
    if name in _CONVNEXT_DEPTHS:
        return _convnext(p, _CONVNEXT_DEPTHS[name])
    if name in _RESNETS:
        return _resnet(p, *_RESNETS[name])
    if name in _RESNESTS:
        return _resnest(p, _RESNESTS[name])
    if name == "cspdarknet":
        return _darknet(p["darknet"])
    raise ValueError(f"Unknown backbone: {name}")


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
    """Any of the four geo heads (by ``gh.name``); ``dims`` are
    ``xyz_mask_region_out_dims`` (the double-mask mask width)."""
    xyz_dim, mask_dim, region_dim = dims
    double = _HEADS[gh.name].double_mask
    sd = {}
    if gh.name == "conv_mask_xyz_region":
        for i in range(sum(k.startswith("conv") for k in p)):
            sd.update(_conv_module(p[f"conv{i}"], f"features.{i}"))
    elif gh.name == "fpn_mask_xyz_region":
        for i in range(4):
            steps = sum(k.startswith(f"scale{i}_conv") for k in p)
            for k in range(steps):
                idx = k if i == 0 else 2 * k      # an Upsample follows each conv above stride 4
                sd.update(_conv_module(p[f"scale{i}_conv{k}"], f"scale_heads.{i}.{idx}"))
    else:
        idx = 0
        for i, up in enumerate(gh.up_types):
            blk = p[f"up{i}"]
            if up == "deconv":
                sd[f"features.{idx}.weight"] = _conv_transpose(blk["deconv"]["kernel"])
                sd.update(_norm(blk, f"features.{idx + 1}"))
                idx += 3
            else:
                idx += 1
            for j in range(gh.num_conv_per_block):
                sd.update(_conv_module(blk[f"conv{j}"], f"features.{idx}"))
                idx += 1
    perm = geo_out_channel_perm(mask_dim if double else mask_dim // 2, xyz_dim, region_dim,
                                nc if gh.mask_class_aware else 1,
                                nc if gh.xyz_class_aware else 1,
                                nc if gh.region_class_aware else 1, double_mask=double)
    w = _conv(p["out_conv_kernel"])                  # (total, I, k, k), JAX order
    b = np.asarray(p["out_conv_bias"])
    w_ref, b_ref = np.empty_like(w), np.empty_like(b)
    w_ref[perm], b_ref[perm] = w, b                  # jax[i] = ref[perm[i]]
    sd["out_layer.weight"], sd["out_layer.bias"] = w_ref, b_ref
    return sd


def _pnp_net(p, pn, output_res) -> Dict[str, np.ndarray]:
    """ConvPnPNet, ConvPnPNetCls or SimplePointPnPNet (by ``pn.name``)."""
    if pn.name in ("point_pnp", "simple_point_pnp"):
        return {k: v for fc in ("conv1", "conv2", "conv3", "fc1", "fc2", "fc_pose")
                for k, v in _dense(p[fc], fc).items()}
    names = ([f"conv_s2_{i}" for i in range(pn.num_stride2_layers)]
             + [f"conv_extra_{i}" for i in range(pn.num_extra_layers)])
    sd = {}
    for li, name in enumerate(names):
        ci = 3 * li
        sd[f"features.{ci}.weight"] = _conv(p[name]["Conv_0"]["kernel"])
        sd.update(_norm(p[name], f"features.{ci + 1}"))
    w1 = _linear(p["fc1"]["kernel"])                  # (1024, fc_in), NHWC flatten
    if pn.flat_op == "flatten":
        s = final_spatial(output_res, pn.num_stride2_layers)
        w1 = (w1.reshape(w1.shape[0], s, s, pn.featdim).transpose(0, 3, 1, 2)
              .reshape(w1.shape[0], -1))              # -> NCHW flatten
    sd["fc1.weight"], sd["fc1.bias"] = w1, np.asarray(p["fc1"]["bias"])
    sd.update(_dense(p["fc2"], "fc2"))
    for fc in ("fc_r", "fc_t"):
        # ConvPnPNetCls: fc_r_kernel (256, classes x out), class-major
        sd.update(_dense(p[fc] if fc in p else {"kernel": p[f"{fc}_kernel"],
                                                "bias": p[f"{fc}_bias"]}, fc))
    return sd


def _fuse_net(p) -> Dict[str, np.ndarray]:
    sd = {}
    for i in range(sum(k.startswith("conv") for k in p)):
        sd[f"conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        sd.update(_affine(p[f"GroupNorm_{i}"], f"gn{i}"))
    return sd


def state_dict_from_flax(params: dict, cfg: Config) -> Dict[str, torch.Tensor]:
    """JAX GDRN params (nested dict of arrays) -> the port's state dict."""
    pc = cfg.model.pose_net
    parts = {
        "backbone": _backbone(params["backbone"], pc.backbone.name),
        "geo_head_net": _geo_head(params["geo_head"], pc.geo_head,
                                  xyz_mask_region_out_dims(pc), pc.num_classes),
        "pnp_net": _pnp_net(params["pnp_net"], pc.pnp_net, pc.output_res),
    }
    if "depth_backbone" in params:          # the RGB-D dual-stream variant
        parts["depth_backbone"] = _backbone(params["depth_backbone"], pc.backbone.name)
    if "fuse_net" in params:                # its ConvFuseNet
        parts["fuse_net"] = _fuse_net(params["fuse_net"])
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
    _focus_to_ref(out, "backbone.backbone.stem.conv.conv.weight")
    return {k: torch.from_numpy(np.array(v, np.int64 if v.dtype == np.int64 else np.float32,
                                         order="C"))
            for k, v in out.items()}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` drawn from ``np.random.RandomState(seed)``:
    weights N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N, layer
    scales U(0.1, 0.5), AconC's p1 and p2 N(0, 1) and beta 1 + 0.1 N (their
    inits' scale); BatchNorm running means 0.1 N and variances U(0.5, 2).
    The same seed gives the same weights on any device."""
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
        elif name.endswith((".acon.p1", ".acon.p2")):
            v = rs.randn(*shape)
        elif name.endswith(".acon.beta"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1 and name.endswith("weight"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            v = 0.1 * rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out
