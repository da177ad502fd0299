"""GDRN's network in fp32: ConvNeXt, the top-down double-mask head, ConvPnPNet.

Functional code over a dict of parameters named as GDRNPP's torch
``state_dict`` (timm's ConvNeXt names, ``geo_head_net.*``, ``pnp_net.*``,
and ``depth_backbone.*`` for the RGB-D dual stream). ``arch`` is the
configuration file's ``model`` block (dotted keys of the configuration as
run) with its ``widths``. The geo head's out conv is GDRNPP's group-major
layout: [visible masks, full masks, x, y, z, regions], each block ordered by
class; the ROI's label picks its channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import rot6d_to_mat, site_decode

PN = "model.pose_net."
LN_EPS = 1e-6
GN_EPS = 1e-5


def _act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "gelu_exact":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"the reference has no activation {name!r}")


def _backbone_act(arch):
    return _act("gelu_exact" if arch[PN + "backbone.gelu_exact"] else "gelu")


def _dstream(arch) -> bool:
    return "dstream" in arch[PN + "name"]


def _head_in(arch) -> int:
    c = arch["widths"]["backbone_dims"][3]
    return 2 * c if _dstream(arch) and arch[PN + "fuse_type"] == "cat" else c


def _head_layout(arch):
    """[(kind, index)] of geo_head_net.features and its parameters."""
    layout, i = [], 0
    for up in arch[PN + "geo_head.up_types"]:
        if up == "deconv":
            layout.append(("deconv", i))
            i += 3
        else:
            layout.append(("up", i))
            i += 1
        for _ in range(arch[PN + "geo_head.num_conv_per_block"]):
            layout.append(("conv", i))
            i += 1
    return layout


def out_channels(arch):
    """(mask, xyz, region) channels per class and the class count."""
    nc = arch[PN + "num_classes"]
    if arch[PN + "loss.xyz_loss_type"] != "L1" or arch[PN + "loss.mask_loss_type"] != "L1":
        raise ValueError("the reference decodes L1 (regression) coordinates and masks")
    return 2, 3, arch[PN + "geo_head.num_regions"] + 1, nc


def param_shapes(arch) -> dict:
    """Every parameter's name and shape, in the model's order."""
    w = arch["widths"]
    depths, dims = w["backbone_depths"], w["backbone_dims"]
    shapes = {}

    def backbone(prefix, cin):
        shapes[prefix + "stem.0.weight"] = (dims[0], cin, 4, 4)
        shapes[prefix + "stem.0.bias"] = (dims[0],)
        shapes[prefix + "stem.1.weight"] = shapes[prefix + "stem.1.bias"] = (dims[0],)
        for s in range(4):
            p = f"{prefix}stages.{s}."
            if s > 0:
                shapes[p + "downsample.0.weight"] = (dims[s - 1],)
                shapes[p + "downsample.0.bias"] = (dims[s - 1],)
                shapes[p + "downsample.1.weight"] = (dims[s], dims[s - 1], 2, 2)
                shapes[p + "downsample.1.bias"] = (dims[s],)
            for b in range(depths[s]):
                q, c = f"{p}blocks.{b}.", dims[s]
                shapes[q + "gamma"] = (c,)
                shapes[q + "conv_dw.weight"] = (c, 1, 7, 7)
                shapes[q + "conv_dw.bias"] = (c,)
                shapes[q + "norm.weight"] = shapes[q + "norm.bias"] = (c,)
                shapes[q + "mlp.fc1.weight"] = (4 * c, c)
                shapes[q + "mlp.fc1.bias"] = (4 * c,)
                shapes[q + "mlp.fc2.weight"] = (c, 4 * c)
                shapes[q + "mlp.fc2.bias"] = (c,)

    backbone("backbone.", arch[PN + "backbone.in_channels"])
    if _dstream(arch):
        backbone("depth_backbone.", 3 if arch["input.bp_depth"] else 1)
    feat, k = arch[PN + "geo_head.feat_dim"], arch[PN + "geo_head.feat_kernel_size"]
    c = _head_in(arch)
    for kind, i in _head_layout(arch):
        p = f"geo_head_net.features.{i}."
        if kind == "deconv":
            kd = arch[PN + "geo_head.deconv_kernel_size"]
            shapes[p + "weight"] = (c, feat, kd, kd)
            shapes[f"geo_head_net.features.{i + 1}.weight"] = (feat,)
            shapes[f"geo_head_net.features.{i + 1}.bias"] = (feat,)
            c = feat
        elif kind == "conv":
            shapes[p + "conv.weight"] = (feat, c, k, k)
            shapes[p + "gn.weight"] = shapes[p + "gn.bias"] = (feat,)
            c = feat
    md, xd, rd, nc = out_channels(arch)
    ko = arch[PN + "geo_head.out_kernel_size"]
    total = (md + xd + rd) * nc
    shapes["geo_head_net.out_layer.weight"] = (total, feat, ko, ko)
    shapes["geo_head_net.out_layer.bias"] = (total,)
    fd = arch[PN + "pnp_net.featdim"]
    cin = 3 + 2 + (rd - 1)
    n2 = arch[PN + "pnp_net.num_stride2_layers"]
    for j in range(n2):
        shapes[f"pnp_net.features.{3 * j}.weight"] = (fd, cin if j == 0 else fd, 3, 3)
        shapes[f"pnp_net.features.{3 * j + 1}.weight"] = (fd,)
        shapes[f"pnp_net.features.{3 * j + 1}.bias"] = (fd,)
    side = arch[PN + "output_res"]
    for _ in range(n2):
        side = (side + 1) // 2
    f1, f2 = w["pnp_fc"]
    for name, (o, i) in (("fc1", (f1, fd * side * side)), ("fc2", (f2, f1)),
                         ("fc_r", (6, f2)), ("fc_t", (3, f2))):
        shapes[f"pnp_net.{name}.weight"] = (o, i)
        shapes[f"pnp_net.{name}.bias"] = (o,)
    return shapes


def _ln2d(x, w, b):
    return F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), w, b, LN_EPS).permute(0, 3, 1, 2)


def convnext(P, prefix, x, arch):
    """ConvNeXt on NCHW input -> the stride-32 features."""
    depths, dims = arch["widths"]["backbone_depths"], arch["widths"]["backbone_dims"]
    act = _backbone_act(arch)
    x = F.conv2d(x, P[prefix + "stem.0.weight"], P[prefix + "stem.0.bias"], stride=4)
    x = _ln2d(x, P[prefix + "stem.1.weight"], P[prefix + "stem.1.bias"])
    for s in range(4):
        p = f"{prefix}stages.{s}."
        if s > 0:
            x = _ln2d(x, P[p + "downsample.0.weight"], P[p + "downsample.0.bias"])
            x = F.conv2d(x, P[p + "downsample.1.weight"], P[p + "downsample.1.bias"], stride=2)
        for b in range(depths[s]):
            q = f"{p}blocks.{b}."
            h = F.conv2d(x, P[q + "conv_dw.weight"], P[q + "conv_dw.bias"], padding=3,
                         groups=dims[s]).permute(0, 2, 3, 1)
            h = F.layer_norm(h, (dims[s],), P[q + "norm.weight"], P[q + "norm.bias"], LN_EPS)
            h = act(F.linear(h, P[q + "mlp.fc1.weight"], P[q + "mlp.fc1.bias"]))
            h = F.linear(h, P[q + "mlp.fc2.weight"], P[q + "mlp.fc2.bias"]) * P[q + "gamma"]
            x = x + h.permute(0, 3, 1, 2)
    return x


def _gn_act(x, w, b, groups, act):
    return act(F.group_norm(x, min(groups, x.shape[1]), w, b, GN_EPS))


def geo_head(P, feat, labels, arch):
    """-> vis_mask (B, H, W), coords (B, 3, H, W), region logits (B, R + 1, H, W)."""
    act = _act(arch[PN + "geo_head.act"])
    g = arch[PN + "geo_head.num_gn_groups"]
    x = feat
    for kind, i in _head_layout(arch):
        p = f"geo_head_net.features.{i}."
        if kind == "deconv":
            kd = P[p + "weight"].shape[-1]
            x = F.conv_transpose2d(x, P[p + "weight"], None, stride=2, padding=(kd - 1) // 2,
                                   output_padding=1)
            q = f"geo_head_net.features.{i + 1}."
            x = _gn_act(x, P[q + "weight"], P[q + "bias"], g, act)
        elif kind == "up":
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            w = P[p + "conv.weight"]
            x = F.conv2d(x, w, None, padding=(w.shape[-1] - 1) // 2)
            x = _gn_act(x, P[p + "gn.weight"], P[p + "gn.bias"], g, act)
    w = P["geo_head_net.out_layer.weight"]
    out = F.conv2d(x, w, P["geo_head_net.out_layer.bias"], padding=(w.shape[-1] - 1) // 2)
    md, xd, rd, nc = out_channels(arch)
    lab = labels.long()
    rows = torch.arange(out.shape[0], device=out.device)
    vis = out[rows, lab]                                   # first half of the mask block
    base = md * nc
    coor = torch.stack([out[rows, base + a * nc + lab] for a in range(3)], dim=1)
    rbase = base + xd * nc
    ridx = rbase + lab[:, None] * rd + torch.arange(rd, device=out.device)
    region = out[rows[:, None], ridx]
    return vis, coor, region


def pnp_net(P, coor, coord_2d, region, extents, arch):
    """ConvPnPNet: -> (rot6d (B, 6), (dx, dy, z_rel) (B, 3))."""
    act = _act(arch[PN + "pnp_net.act"])
    g = arch[PN + "pnp_net.num_gn_groups"]
    xyz = (coor - 0.5) * extents[:, :, None, None]
    x = torch.cat([xyz, coord_2d.permute(0, 3, 1, 2), torch.softmax(region[:, 1:], dim=1)], 1)
    for j in range(arch[PN + "pnp_net.num_stride2_layers"]):
        x = F.conv2d(x, P[f"pnp_net.features.{3 * j}.weight"], None, stride=2, padding=1)
        q = f"pnp_net.features.{3 * j + 1}."
        x = _gn_act(x, P[q + "weight"], P[q + "bias"], g, act)
    h = act(F.linear(torch.flatten(x, 1), P["pnp_net.fc1.weight"], P["pnp_net.fc1.bias"]))
    h = act(F.linear(h, P["pnp_net.fc2.weight"], P["pnp_net.fc2.bias"]))
    return (F.linear(h, P["pnp_net.fc_r.weight"], P["pnp_net.fc_r.bias"]),
            F.linear(h, P["pnp_net.fc_t.weight"], P["pnp_net.fc_t.bias"]))


def forward(P, arch, roi_img, roi_depth, labels, roi_coord_2d, extents, Ks, centers, whs,
            resize_ratios):
    """The network and the pose decode. roi_img (B, H, W, 3) normalised,
    roi_depth (B, H, W, 3) backprojected or None, roi_coord_2d (B, h, w, 2),
    extents (B, 3). Returns rot (B, 3, 3), trans (B, 3), vis_mask (B, h, w),
    coor (B, 3, h, w)."""
    for key, want in ((PN + "pnp_net.rot_type", "allo_rot6d"),
                      (PN + "pnp_net.trans_type", "centroid_z"), (PN + "pnp_net.z_type", "REL"),
                      (PN + "pnp_net.flat_op", "flatten"), (PN + "pnp_net.coord_2d_type", "abs"),
                      (PN + "pnp_net.name", "conv_pnp_net"), (PN + "pnp_net.with_2d_coord", True),
                      (PN + "pnp_net.region_attention", True),
                      (PN + "pnp_net.mask_attention", "none"),
                      (PN + "pnp_net.denormalize_by_extent", True),
                      (PN + "geo_head.name", "top_down_doublemask_xyz_region")):
        if arch[key] != want:
            raise ValueError(f"the reference decodes {key}={want!r}, not {arch[key]!r}")
    feat = convnext(P, "backbone.", roi_img.permute(0, 3, 1, 2), arch)
    if _dstream(arch):
        dfeat = convnext(P, "depth_backbone.", roi_depth.permute(0, 3, 1, 2), arch)
        if arch[PN + "fuse_type"] != "cat":
            raise ValueError("the reference fuses the two streams by concatenation")
        feat = torch.cat([feat, dfeat], dim=1)
    vis, coor, region = geo_head(P, feat, labels, arch)
    rot6d, t_pred = pnp_net(P, coor, roi_coord_2d, region, extents, arch)
    rot, trans = site_decode(rot6d_to_mat(rot6d), t_pred, Ks, centers, whs, resize_ratios)
    return {"rot": rot, "trans": trans, "vis_mask": vis, "coor": coor}
