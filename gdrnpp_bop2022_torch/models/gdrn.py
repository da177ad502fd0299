"""GDRN assembly: ConvNeXt -> double-mask geo head -> ConvPnPNet -> pose decode.

Port of ``gdrnpp_bop2022_tpu/models/gdrn.py`` for the served configurations:
a convnext_{tiny,small,base} backbone, ``top_down_doublemask_xyz_region``
head and ``conv_pnp_net``, as RGB (``gdrn_double_mask``) or RGB-D
(``gdrn_dstream_double_mask``: a second ConvNeXt, ``depth_backbone``, over
the backprojected depth ROI, fused by channel concat or sum). The other
backbones, heads and PnP nets, ConvFuseNet and cls2reg arrive in later
slices and raise here.

The public interface keeps the JAX package's layout: ``forward`` takes the
batch dict of ``engine.batching.build_test_batch`` (roi_img (B, H, W, 3),
roi_coord_2d (B, h, w, 2), ...) and returns the dense maps channel-last,
so both packages compare like with like. Inside, tensors are NCHW in
channels_last memory. Parameter names are the reference's torch names
(``backbone.*``, ``geo_head_net.*``, ``pnp_net.*``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config, PoseNetConfig
from ..geometry.rotations import quat_to_mat, rot6d_to_mat
from ..geometry.se3 import (pose_from_centroid_z_abs, pose_from_centroid_z_rel,
                            pose_from_trans)
from .backbones.convnext import convnext_base, convnext_small, convnext_tiny
from .heads.conv_pnp_net import ConvPnPNet
from .heads.top_down_head import TopDownDoubleMaskXyzRegionHead

_BACKBONES = {"convnext_tiny": (convnext_tiny, 768),
              "convnext_small": (convnext_small, 768),
              "convnext_base": (convnext_base, 1024)}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def xyz_mask_region_out_dims(cfg: PoseNetConfig) -> tuple[int, int, int]:
    """Per-class channel counts (xyz, mask, region)."""
    lc = cfg.loss
    if lc.xyz_loss_type in ("L1", "MSE", "L2", "SmoothL1"):
        xyz_out_dim = 3
    elif lc.xyz_loss_type in ("CE_coor", "CE"):
        xyz_out_dim = 3 * (cfg.geo_head.xyz_num_bins + 1)
    else:
        raise NotImplementedError(lc.xyz_loss_type)
    if lc.mask_loss_type in ("L1", "BCE", "RW_BCE", "dice"):
        mask_out_dim = 2
    elif lc.mask_loss_type == "CE":
        mask_out_dim = 4
    else:
        raise NotImplementedError(lc.mask_loss_type)
    region_out_dim = (cfg.geo_head.num_regions + 1
                      if cfg.geo_head.num_regions > 0 else 0)
    return xyz_out_dim, mask_out_dim, region_out_dim


def get_mask_prob(pred_mask: torch.Tensor, mask_loss_type: str) -> torch.Tensor:
    """Raw visible-mask output (B, H, W, 1) -> probability map."""
    if mask_loss_type == "L1":
        mx = pred_mask.amax(dim=(1, 2, 3), keepdim=True)
        mn = pred_mask.amin(dim=(1, 2, 3), keepdim=True)
        return (pred_mask - mn) / (mx - mn).clamp_min(1e-12)
    if mask_loss_type in ("BCE", "RW_BCE", "dice"):
        return torch.sigmoid(pred_mask)
    if mask_loss_type == "CE":
        return torch.softmax(pred_mask, dim=-1)[..., 1:2]
    raise NotImplementedError(mask_loss_type)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class GDRN(nn.Module):
    """Geometry-guided direct regression network (double-mask variant).

    forward also takes roi_depth (B,H,W,3|1) for the dual-stream model
    (``engine.batching.build_depth_rois``) and returns: rot (B,3,3)
    egocentric, trans (B,3), rot_allo, centroid_rel (B,2), z_rel (B,),
    vis_mask / full_mask (B,H,W) raw, coor_x/y/z (B,H,W,D), region
    (B,H,W,R+1) raw logits; all fp32.
    """

    def __init__(self, cfg: PoseNetConfig, dtype: torch.dtype = torch.bfloat16,
                 depth_in_chans: int = 3):
        super().__init__()
        self.cfg = cfg
        bb, gh, pn = cfg.backbone, cfg.geo_head, cfg.pnp_net
        if bb.name not in _BACKBONES:
            raise NotImplementedError(f"backbone {bb.name!r} arrives with slice 5")
        if gh.name != "top_down_doublemask_xyz_region":
            raise NotImplementedError(f"geo_head {gh.name!r} arrives with slice 5")
        if pn.name != "conv_pnp_net":
            raise NotImplementedError(f"pnp_net {pn.name!r} arrives with slice 5")
        dstream = "dstream" in cfg.name
        if dstream and cfg.fuse_type not in ("cat", "add"):
            raise NotImplementedError(f"fuse_type {cfg.fuse_type!r} (ConvFuseNet) "
                                      "arrives with slice 5")
        if "cls2reg" in cfg.name or cfg.loss.use_mtl:
            raise NotImplementedError(f"GDRN variant {cfg.name!r} "
                                      f"(use_mtl={cfg.loss.use_mtl}) arrives later")
        if bb.out_index != 3:
            raise NotImplementedError("only the stride-32 feature (out_index 3)")
        build, feat_dim = _BACKBONES[bb.name]
        self.backbone = build(out_indices=(3,), gelu_exact=bb.gelu_exact,
                              in_chans=bb.in_channels, dtype=dtype)
        # RGB-D dual stream (reference GDRN_Dstream_double_mask.py:37): the
        # same backbone over the depth ROI (3 channels backprojected, else 1)
        self.depth_backbone = (build(out_indices=(3,), gelu_exact=bb.gelu_exact,
                                     in_chans=depth_in_chans, dtype=dtype)
                               if dstream else None)
        if dstream and cfg.fuse_type == "cat":
            feat_dim *= 2
        xyz_dim, mask_dim, region_dim = xyz_mask_region_out_dims(cfg)
        self._dims = (xyz_dim, mask_dim, region_dim)
        nc = cfg.num_classes
        self.geo_head_net = TopDownDoubleMaskXyzRegionHead(
            feat_dim, up_types=gh.up_types,
            deconv_kernel_size=gh.deconv_kernel_size,
            num_conv_per_block=gh.num_conv_per_block, feat_dim=gh.feat_dim,
            feat_kernel_size=gh.feat_kernel_size, norm=gh.norm,
            num_gn_groups=gh.num_gn_groups, act=gh.act,
            out_kernel_size=gh.out_kernel_size,
            mask_num_classes=nc if gh.mask_class_aware else 1,
            xyz_num_classes=nc if gh.xyz_class_aware else 1,
            region_num_classes=nc if gh.region_class_aware else 1,
            mask_out_dim=mask_dim, xyz_out_dim=xyz_dim,
            region_out_dim=region_dim, dtype=dtype)
        coor_c = 3 if xyz_dim == 3 else xyz_dim - 3     # binned: bg bin dropped
        pnp_in = (coor_c + (2 if pn.with_2d_coord else 0)
                  + (region_dim - 1 if region_dim > 0 and pn.region_attention else 0)
                  + (1 if pn.mask_attention == "concat" else 0))
        self.pnp_net = ConvPnPNet(
            pnp_in, featdim=pn.featdim, rot_dim=6 if "rot6d" in pn.rot_type else 4,
            num_stride2_layers=pn.num_stride2_layers,
            num_extra_layers=pn.num_extra_layers, norm=pn.norm,
            num_gn_groups=pn.num_gn_groups, act=pn.act, drop_prob=pn.drop_prob,
            dropblock_size=pn.dropblock_size, flat_op=pn.flat_op,
            denormalize_by_extent=pn.denormalize_by_extent,
            mask_attention=pn.mask_attention, output_res=cfg.output_res,
            dtype=dtype)

    def forward(self, roi_img, roi_labels, roi_coord_2d, roi_cams, roi_centers,
                roi_whs, roi_extents, resize_ratios, roi_depth=None) -> dict:
        pc, pn = self.cfg, self.cfg.pnp_net
        xyz_dim, mask_dim, region_dim = self._dims
        if roi_img.shape[-1] != pc.backbone.in_channels:
            raise ValueError(f"roi_img has {roi_img.shape[-1]} channels but "
                             f"backbone.in_channels={pc.backbone.in_channels}")
        # (B, H, W, 3) contiguous -> NCHW view in channels_last memory
        feat = self.backbone(roi_img.permute(0, 3, 1, 2))
        if self.depth_backbone is not None:
            if roi_depth is None:
                raise ValueError("the dstream model needs roi_depth")
            dfeat = self.depth_backbone(roi_depth.permute(0, 3, 1, 2))
            feat = (feat + dfeat if pc.fuse_type == "add"
                    else torch.cat([feat, dfeat], dim=1))
        geo = self.geo_head_net(feat, labels=roi_labels)
        coor_x, coor_y, coor_z = geo["coor_x"], geo["coor_y"], geo["coor_z"]
        region = geo["region"]

        if coor_x.shape[1] > 1:   # binned: softmax over bins, bg bin excluded
            coor_feat = torch.cat([torch.softmax(c[:, :-1], dim=1)
                                   for c in (coor_x, coor_y, coor_z)], dim=1)
        else:
            coor_feat = torch.cat([coor_x, coor_y, coor_z], dim=1)
        if pn.with_2d_coord:
            coor_feat = torch.cat(
                [coor_feat, roi_coord_2d.permute(0, 3, 1, 2).to(coor_feat.dtype)],
                dim=1)
        region_atten = None
        if region_dim > 0 and pn.region_attention:
            region_atten = torch.softmax(region[:, 1:], dim=1)  # leading bg dropped
        mask_atten = None
        if pn.mask_attention != "none":
            mask_atten = get_mask_prob(_nhwc(geo["vis_mask"]),
                                       pc.loss.mask_loss_type).permute(0, 3, 1, 2)
        pred_rot_, pred_t_ = self.pnp_net(coor_feat, region=region_atten,
                                          extents=roi_extents,
                                          mask_attention=mask_atten)

        if "rot6d" in pn.rot_type:
            rot_allo = rot6d_to_mat(pred_rot_)
        elif "quat" in pn.rot_type:
            rot_allo = quat_to_mat(pred_rot_)
        else:
            raise ValueError(pn.rot_type)
        is_allo = "allo" in pn.rot_type
        if pn.trans_type == "centroid_z":
            rot_ego, trans = pose_from_centroid_z_rel(
                rot_allo, pred_t_[:, :2], pred_t_[:, 2], roi_cams, roi_centers,
                resize_ratios, roi_whs, is_allo=is_allo, z_type=pn.z_type)
        elif pn.trans_type == "centroid_z_abs":
            rot_ego, trans = pose_from_centroid_z_abs(
                rot_allo, pred_t_[:, :2], pred_t_[:, 2], roi_cams, is_allo=is_allo)
        elif pn.trans_type == "trans":
            rot_ego, trans = pose_from_trans(rot_allo, pred_t_, is_allo=is_allo)
        else:
            raise ValueError(pn.trans_type)

        vis, full = _nhwc(geo["vis_mask"]), _nhwc(geo["full_mask"])
        squeeze = mask_dim // 2 == 1
        return {
            "log_vars": None,
            "rot": rot_ego,
            "rot_allo": rot_allo,
            "trans": trans,
            "centroid_rel": pred_t_[:, :2],
            "z_rel": pred_t_[:, 2],
            "vis_mask": vis[..., 0] if squeeze else vis,
            "full_mask": full[..., 0] if squeeze else full,
            "coor_x": _nhwc(coor_x),
            "coor_y": _nhwc(coor_y),
            "coor_z": _nhwc(coor_z),
            "region": _nhwc(region),
        }


def build_gdrn(cfg: Config, device="cuda") -> GDRN:
    """GDRN for ``cfg`` in ``cfg.model.compute_dtype``, in eval mode, on
    ``device`` (the card unless the caller asks for the CPU)."""
    model = GDRN(cfg.model.pose_net, dtype=_DTYPES[cfg.model.compute_dtype],
                 depth_in_chans=3 if cfg.input.bp_depth else 1)
    return model.to(device).eval()


def normalize_image(img: torch.Tensor, pixel_mean, pixel_std) -> torch.Tensor:
    """(B, H, W, 3) uint8/float -> (x - mean) / std in fp32."""
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=img.device)
    return (img.float() - mean) / std
