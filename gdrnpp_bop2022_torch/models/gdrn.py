"""GDRN assembly: backbone -> geo head -> PnP net -> pose decode.

Port of ``gdrnpp_bop2022_tpu/models/gdrn.py`` with every variant it builds:

  * backbones: convnext_{tiny,small,base} (its LayerNorms through kernel
    B1), resnet34/50/101, resnet18_8s / resnet34_8s (dilated, stride 8),
    resnest50/101 and cspdarknet (YOLOX's CSPDarknet at width and depth 1,
    stage features 1-3 = dark3-5), each with ``backbone.in_channels`` input
    channels (6 for early RGB-D fusion);
  * geo heads: ``top_down_doublemask_xyz_region``,
    ``top_down_mask_xyz_region``, ``conv_mask_xyz_region`` (at the stride
    of ``backbone.out_index``) and ``fpn_mask_xyz_region`` (stage features
    0-3); the single-mask heads return ``full_mask`` None;
  * PnP nets: ``conv_pnp_net``, ``conv_pnp_net_cls`` (class-aware FCs, given
    the labels), ``point_pnp`` / ``simple_point_pnp`` (SimplePointPnPNet with
    the global max pool, as the JAX GDRN builds it);
  * ``gdrn_cls2reg``: binned (CE) coordinates decoded for the PnP net by
    ``soft_argmax`` over every bin, the background bin included;
  * the dual stream (``gdrn_dstream_*``): a second backbone, ``depth_backbone``,
    over the depth ROI, fused by concat, sum or ConvFuseNet
    (``fuse_type="conv"``).

Unknown backbone, head or PnP names raise ``ValueError``. With
``loss.use_mtl`` the model holds one learned log-variance per loss term
(``log_var_<name>``, scalars).

The public interface keeps the JAX package's layout: ``forward`` takes the
batch dict of ``engine.batching.build_test_batch`` (roi_img (B, H, W, 3),
roi_coord_2d (B, h, w, 2), ...) and returns the dense maps channel-last,
so both packages compare like with like. Inside, tensors are NCHW (channels_last
memory for ConvNeXt). Parameter names are the reference's torch names
(``backbone.*``, ``geo_head_net.*``, ``pnp_net.*``, ``fuse_net.*``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import Config, PoseNetConfig
from ..geometry.rotations import quat_to_mat, rot6d_to_mat
from ..geometry.se3 import (pose_from_centroid_z_abs, pose_from_centroid_z_rel,
                            pose_from_trans)
from .backbones.convnext import convnext_base, convnext_small, convnext_tiny
from .backbones.resnest import resnest50, resnest101
from .backbones.resnet import resnet18_8s, resnet34, resnet34_8s, resnet50, resnet101
from .heads.conv_pnp_net import ConvPnPNet, ConvPnPNetCls
from .heads.point_pnp_net import ConvFuseNet, SimplePointPnPNet
from .heads.top_down_head import (ConvMaskXyzRegionHead, FPNMaskXyzRegionHead,
                                  TopDownDoubleMaskXyzRegionHead, TopDownMaskXyzRegionHead)
from .layers import DropMasks, soft_argmax
from .yolox.darknet import CSPDarknet

# the loss terms use_mtl weights, each as loss_<name>
MTL_NAMES = ("mask", "mask_full", "coor_x", "coor_y", "coor_z", "region", "PM_R", "PM_RT",
             "PM_xy", "PM_z", "PM_xy_noP", "PM_z_noP", "PM_T", "PM_T_noP", "centroid", "z",
             "trans_xy", "trans_z", "trans_LPnP", "rot", "bind")


class CSPDarknetBackbone(CSPDarknet):
    """YOLOX's CSPDarknet (GN, width and depth 1) as a GDRN backbone: stage
    features 1, 2, 3 are dark3, dark4, dark5 (strides 8, 16, 32); its Focus
    stem takes the ROI as it is."""

    def __init__(self, out_indices=(3,), in_chans: int = 3, dtype=torch.bfloat16):
        if any(i not in (1, 2, 3) for i in out_indices):
            raise ValueError(f"cspdarknet has stage features 1-3, not {out_indices}")
        super().__init__(1.0, 1.0, dtype=dtype, in_chans=in_chans)
        self.out_indices = tuple(out_indices)

    def forward(self, x, drop: Optional[DropMasks] = None):
        feats = super().forward(x)
        out = [feats[i - 1] for i in self.out_indices]
        return out if len(out) > 1 else out[0]


# name -> (constructor, width of stage features 0-3)
_BACKBONES = {"convnext_tiny": (convnext_tiny, (96, 192, 384, 768)),
              "convnext_small": (convnext_small, (96, 192, 384, 768)),
              "convnext_base": (convnext_base, (128, 256, 512, 1024)),
              "resnet34": (resnet34, (64, 128, 256, 512)),
              "resnet50": (resnet50, (256, 512, 1024, 2048)),
              "resnet101": (resnet101, (256, 512, 1024, 2048)),
              # pvnet-heritage dilated stride-8 nets: pair with the conv-only
              # geo head and output_res = input_res // 8
              "resnet18_8s": (resnet18_8s, (64, 128, 256, 512)),
              "resnet34_8s": (resnet34_8s, (64, 128, 256, 512)),
              "resnest50": (resnest50, (256, 512, 1024, 2048)),
              "resnest101": (resnest101, (256, 512, 1024, 2048)),
              "cspdarknet": (CSPDarknetBackbone, (None, 256, 512, 1024))}
_HEADS = {"top_down_doublemask_xyz_region": TopDownDoubleMaskXyzRegionHead,
          "top_down_mask_xyz_region": TopDownMaskXyzRegionHead,
          "conv_mask_xyz_region": ConvMaskXyzRegionHead,
          "fpn_mask_xyz_region": FPNMaskXyzRegionHead}
_PNP_NETS = ("conv_pnp_net", "conv_pnp_net_cls", "point_pnp", "simple_point_pnp")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _build_backbone(bb, out_indices, in_chans: int, dtype):
    if bb.name not in _BACKBONES:
        raise ValueError(f"Unknown backbone: {bb.name}")
    build, widths = _BACKBONES[bb.name]
    kw = {"gelu_exact": bb.gelu_exact} if "convnext" in bb.name else {}
    model = build(out_indices=out_indices, in_chans=in_chans, dtype=dtype, **kw)
    return model, [widths[i] for i in out_indices]


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
    """Geometry-guided direct regression network, every variant of the JAX
    package's ``GDRN``.

    forward also takes roi_depth (B,H,W,3|1) for the dual-stream model
    (``engine.batching.build_depth_rois``) and returns: rot (B,3,3)
    egocentric, trans (B,3), rot_allo, centroid_rel (B,2), z_rel (B,),
    vis_mask / full_mask (B,H,W) raw (full_mask None for a single-mask
    head), coor_x/y/z (B,H,W,D), region (B,H,W,R+1) raw logits; all fp32.
    """

    def __init__(self, cfg: PoseNetConfig, dtype: torch.dtype = torch.bfloat16,
                 depth_in_chans: int = 3):
        super().__init__()
        self.cfg = cfg
        bb, gh, pn = cfg.backbone, cfg.geo_head, cfg.pnp_net
        if gh.name not in _HEADS:
            raise ValueError(f"Unknown geo_head.name: {gh.name!r}; "
                             f"expected one of {sorted(_HEADS)}")
        if pn.name not in _PNP_NETS:
            raise ValueError(f"Unknown pnp_net.name: {pn.name!r}; expected one of {_PNP_NETS}")
        fpn = gh.name == "fpn_mask_xyz_region"
        dstream = "dstream" in cfg.name
        if dstream and fpn:
            raise ValueError("dstream fusion is single-scale; use a top-down/conv geo head")
        # cls2reg decodes binned coordinates by soft-argmax
        # (reference GDRN_cls2reg.py:142-148)
        self.cls2reg = "cls2reg" in cfg.name
        if self.cls2reg and cfg.loss.xyz_loss_type not in ("CE_coor", "CE"):
            raise ValueError("gdrn_cls2reg requires binned (CE) xyz outputs")
        self.backbone, widths = _build_backbone(bb, (0, 1, 2, 3) if fpn else (bb.out_index,),
                                                bb.in_channels, dtype)
        # RGB-D dual stream (reference GDRN_Dstream_double_mask.py:37): the
        # same backbone over the depth ROI (3 channels backprojected, else 1),
        # fused by concat, sum or ConvFuseNet
        self.depth_backbone = (_build_backbone(bb, (bb.out_index,), depth_in_chans, dtype)[0]
                               if dstream else None)
        self.fuse_net = (ConvFuseNet(widths[0], widths[0], dtype=dtype)
                         if dstream and cfg.fuse_type == "conv" else None)
        feat_dim = widths[0] * (2 if dstream and cfg.fuse_type == "cat" else 1)
        xyz_dim, mask_dim, region_dim = xyz_mask_region_out_dims(cfg)
        self._dims = (xyz_dim, mask_dim, region_dim)
        nc = cfg.num_classes
        head_cls = _HEADS[gh.name]
        head_kw = dict(feat_dim=gh.feat_dim, feat_kernel_size=gh.feat_kernel_size,
                       norm=gh.norm, num_gn_groups=gh.num_gn_groups, act=gh.act,
                       out_kernel_size=gh.out_kernel_size,
                       mask_num_classes=nc if gh.mask_class_aware else 1,
                       xyz_num_classes=nc if gh.xyz_class_aware else 1,
                       region_num_classes=nc if gh.region_class_aware else 1,
                       # a single-mask head carries the visible mask's channels only
                       mask_out_dim=mask_dim if head_cls.double_mask else mask_dim // 2,
                       xyz_out_dim=xyz_dim, region_out_dim=region_dim, dtype=dtype)
        if gh.name.startswith("top_down"):
            head_kw.update(up_types=gh.up_types, deconv_kernel_size=gh.deconv_kernel_size,
                           num_conv_per_block=gh.num_conv_per_block)
        self.geo_head_net = head_cls(widths if fpn else feat_dim, **head_kw)
        # binned: the bg bin dropped (softmax) or all bins -> one value (cls2reg)
        coor_c = 3 if xyz_dim == 3 or self.cls2reg else xyz_dim - 3
        pnp_in = (coor_c + (2 if pn.with_2d_coord else 0)
                  + (region_dim - 1 if region_dim > 0 and pn.region_attention else 0)
                  + (1 if pn.mask_attention == "concat" else 0))
        rot_dim = 6 if "rot6d" in pn.rot_type else 4
        if pn.name in ("point_pnp", "simple_point_pnp"):
            self.pnp_net = SimplePointPnPNet(
                pnp_in, rot_dim=rot_dim, mask_attention=pn.mask_attention,
                denormalize_by_extent=pn.denormalize_by_extent, dtype=dtype)
        else:
            pnp_kw = dict(featdim=pn.featdim, rot_dim=rot_dim,
                          num_stride2_layers=pn.num_stride2_layers,
                          num_extra_layers=pn.num_extra_layers, norm=pn.norm,
                          num_gn_groups=pn.num_gn_groups, act=pn.act, drop_prob=pn.drop_prob,
                          dropblock_size=pn.dropblock_size, flat_op=pn.flat_op,
                          denormalize_by_extent=pn.denormalize_by_extent,
                          mask_attention=pn.mask_attention, output_res=cfg.output_res,
                          dtype=dtype)
            self.pnp_net = (ConvPnPNetCls(pnp_in, nc, **pnp_kw) if pn.name == "conv_pnp_net_cls"
                            else ConvPnPNet(pnp_in, **pnp_kw))
        # learned task-uncertainty weighting (reference USE_MTL,
        # GDRN_double_mask.py:54-64): one log-variance per loss term
        self.mtl_names = MTL_NAMES if cfg.loss.use_mtl else ()
        for name in self.mtl_names:
            self.register_parameter(f"log_var_{name}", nn.Parameter(torch.zeros(())))

    def forward(self, roi_img, roi_labels, roi_coord_2d, roi_cams, roi_centers,
                roi_whs, roi_extents, resize_ratios, roi_depth=None,
                drop: Optional[DropMasks] = None, progress: float = 1.0) -> dict:
        """``drop`` gives drop_path's and DropBlock's masks in training,
        ``progress`` (the share of the run done) DropBlock's ramp."""
        pc, pn = self.cfg, self.cfg.pnp_net
        xyz_dim, mask_dim, region_dim = self._dims
        if roi_img.shape[-1] != pc.backbone.in_channels:
            raise ValueError(f"roi_img has {roi_img.shape[-1]} channels but "
                             f"backbone.in_channels={pc.backbone.in_channels}")
        # (B, H, W, C) contiguous -> NCHW view in channels_last memory
        feat = self.backbone(roi_img.permute(0, 3, 1, 2), drop)
        if self.depth_backbone is not None:
            if roi_depth is None:
                raise ValueError("the dstream model needs roi_depth")
            dfeat = self.depth_backbone(roi_depth.permute(0, 3, 1, 2), drop)
            if self.fuse_net is not None:
                feat = self.fuse_net(feat, dfeat)
            elif pc.fuse_type == "add":
                feat = feat + dfeat
            else:
                feat = torch.cat([feat, dfeat], dim=1)
        geo = self.geo_head_net(feat, labels=roi_labels)
        coor_x, coor_y, coor_z = geo["coor_x"], geo["coor_y"], geo["coor_z"]
        region = geo["region"]

        if coor_x.shape[1] > 1 and self.cls2reg:    # near-hard soft-argmax, all bins
            coor_feat = torch.cat([soft_argmax(c) for c in (coor_x, coor_y, coor_z)], dim=1)
        elif coor_x.shape[1] > 1:   # binned: softmax over bins, bg bin excluded
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
        pnp_kw = {"labels": roi_labels} if pn.name == "conv_pnp_net_cls" else {}
        pred_rot_, pred_t_ = self.pnp_net(coor_feat, region=region_atten,
                                          extents=roi_extents,
                                          mask_attention=mask_atten, drop=drop,
                                          progress=progress, **pnp_kw)

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

        squeeze = mask_dim // 2 == 1
        masks = {}
        for k in ("vis_mask", "full_mask"):
            m = None if geo[k] is None else _nhwc(geo[k])
            masks[k] = m[..., 0] if m is not None and squeeze else m
        return {
            "log_vars": ({n: getattr(self, f"log_var_{n}") for n in self.mtl_names}
                         if self.mtl_names else None),
            "rot": rot_ego,
            "rot_allo": rot_allo,
            "trans": trans,
            "centroid_rel": pred_t_[:, :2],
            "z_rel": pred_t_[:, 2],
            **masks,
            "coor_x": _nhwc(coor_x),
            "coor_y": _nhwc(coor_y),
            "coor_z": _nhwc(coor_z),
            "region": _nhwc(region),
        }


def build_gdrn(cfg: Config, device="cuda", train: bool = False) -> GDRN:
    """GDRN for ``cfg`` in ``cfg.model.compute_dtype`` on ``device`` (the
    card unless the caller asks for the CPU), in eval mode, or in train mode
    for the trainer (the forward is the same; drop_path and DropBlock are
    all it switches)."""
    model = GDRN(cfg.model.pose_net, dtype=_DTYPES[cfg.model.compute_dtype],
                 depth_in_chans=3 if cfg.input.bp_depth else 1)
    return model.to(device).train(train)


def normalize_image(img: torch.Tensor, pixel_mean, pixel_std) -> torch.Tensor:
    """(B, H, W, 3) uint8/float -> (x - mean) / std in fp32."""
    mean = torch.as_tensor(pixel_mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(pixel_std, dtype=torch.float32, device=img.device)
    return (img.float() - mean) / std
