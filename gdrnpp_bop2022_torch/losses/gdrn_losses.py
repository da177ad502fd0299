"""GDRN training losses, batched.

Port of ``gdrnpp_bop2022_tpu/losses/gdrn_losses.py`` (reference
core/gdrn_modeling/models/GDRN_double_mask.py:287-535 gdrn_loss and
losses/{pm_loss,mask_losses,coor_cross_entropy,rot_loss}.py), every branch:
xyz (L1, CE_coor), visible and full masks (L1, BCE, dice, RW_BCE), region
CE, point matching (symmetric, R only or with t, disentangled), rotation,
centroid, z, translation and the R^T t bind loss. Reductions follow the
reference: sum over the mask / mask count for the dense heads, means for the
pose heads. Dense tensors are channel-last (B, H, W, C); masks (B, H, W).
With ``use_mtl`` each term is weighted by the model's learned
log-variance of its name.

Data parallel (``parallel/``): each rank holds a slice of the global batch
and the gradients are averaged over the ranks, so a masked term's count is
the global batch's (``global_sum``) and its local sum is scaled by the
world size; the ranks' average is then the global batch's loss, as under
the JAX mesh. Plain means need nothing. In a world of one both are exact
identities.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from ..geometry.se3 import transform_pts
from ..geometry.symmetry import get_closest_rot_batch
from ..parallel.distributed import global_sum, world_size


def masked_xyz_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1 over the mask, over the mask's count (the global batch's).
    pred/gt (B, H, W, C), mask (B, H, W)."""
    m = mask[..., None]
    return (pred * m - gt * m).abs().sum() * world_size() / global_sum(mask.sum()).clamp_min(1.0)


def _masked_sum_ce(logits, targets, mask):
    """The reference's masked CE: CE(logits * mask, targets * mask, "sum") /
    n_mask (the global batch's). A masked-out pixel adds the constant log(C)
    with no gradient; it is added in closed form so loss values match the
    reference's logs."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    n_mask = mask.sum()
    const = (mask.numel() - n_mask) * math.log(logits.shape[-1])
    return ((nll * mask).sum() + const) * world_size() / global_sum(n_mask).clamp_min(1.0)


def xyz_ce_loss(logits: torch.Tensor, gt_bins: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """CE of binned coordinates: logits (B, H, W, bins+1), gt_bins (B, H, W)."""
    return _masked_sum_ce(logits, gt_bins, mask)


def _soft_dice(probs: torch.Tensor, gt: torch.Tensor, eps: float = 0.002) -> torch.Tensor:
    # per-sample dice with plain sums in the denominator and eps only there
    # (reference mask_losses.py:442-461, smooth=0)
    p = probs.reshape(probs.shape[0], -1)
    g = gt.reshape(gt.shape[0], -1)
    inter = (p * g).sum(1)
    denom = p.sum(1) + g.sum(1)
    return (1.0 - 2.0 * inter / (denom + eps)).mean()


def mask_loss(pred_logits: torch.Tensor, gt: torch.Tensor, loss_type: str = "L1") -> torch.Tensor:
    """Loss of a one-channel mask output (B, H, W) against gt in [0, 1]."""
    if loss_type == "L1":
        return (pred_logits - gt).abs().mean()
    if loss_type == "BCE":
        return (pred_logits.clamp_min(0) - pred_logits * gt
                + torch.log1p(torch.exp(-pred_logits.abs()))).mean()
    if loss_type == "dice":
        return _soft_dice(torch.sigmoid(pred_logits), gt)
    if loss_type == "RW_BCE":
        # weighted_ex_loss_probs (reference mask_losses.py:63-106): positive
        # and negative pixels of the whole batch, each side over its own count
        probs = torch.sigmoid(pred_logits).clamp(1e-7, 1 - 1e-7)
        pos = (gt > 0).to(probs.dtype)
        neg = 1.0 - pos
        w = world_size()
        pos_loss = (-gt * torch.log(probs) * pos).sum() * w
        neg_loss = (-torch.log(1.0 - probs) * neg).sum() * w
        n_pos, n_neg = global_sum(pos.sum()), global_sum(neg.sum())
        zero = torch.zeros_like(pos_loss)
        return (torch.where(n_pos > 0, pos_loss / n_pos.clamp_min(1.0), zero)
                + torch.where(n_neg > 0, neg_loss / n_neg.clamp_min(1.0), zero))
    raise ValueError(f"unknown mask loss type: {loss_type}")


def region_ce_loss(logits: torch.Tensor, gt_region: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Region CE, masked and over the mask count: logits (B, H, W, R+1)."""
    return _masked_sum_ce(logits, gt_region, mask)


def _elem_loss(x: torch.Tensor, y: torch.Tensor, loss_type: str, beta: float = 1.0) -> torch.Tensor:
    d = x - y
    if loss_type in ("l1", "L1"):
        return d.abs()
    if loss_type in ("mse", "MSE"):
        return d * d
    if loss_type == "smooth_l1":
        ad = d.abs()
        return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)
    raise ValueError(f"loss type {loss_type} not supported")


def _reduced_loss(x: torch.Tensor, y: torch.Tensor, loss_type: str,
                  beta: float = 1.0) -> torch.Tensor:
    """L1/MSE: elementwise mean; L2 (reference l2_loss.py:5-27): the batch
    mean of each sample's flattened L2 norm."""
    if loss_type in ("l2", "L2"):
        d = (x - y).reshape(x.shape[0], -1)
        return torch.sqrt((d * d).sum(1)).mean()
    return _elem_loss(x, y, loss_type, beta).mean()


def point_matching_loss(pred_rots, gt_rots, points, pred_transes=None, gt_transes=None,
                        extents=None, sym_bank=None, sym_mask=None, labels=None,
                        loss_type: str = "l1", beta: float = 1.0,
                        norm_by_extent: bool = True, symmetric: bool = True,
                        r_only: bool = True, disentangle_t: bool = False,
                        disentangle_z: bool = False, t_loss_use_points: bool = True,
                        loss_weight: float = 1.0) -> dict:
    """Symmetry-aware point-matching loss (reference losses/pm_loss.py:20-200).
    points (B, N, 3); sym_bank (C, S, 3, 3), sym_mask (C, S), labels (B,)."""
    if symmetric:
        if sym_bank is None or labels is None:
            raise ValueError("symmetric point matching needs sym_bank and labels")
        gt_rots = get_closest_rot_batch(pred_rots, gt_rots, sym_bank, sym_mask, labels)
    points_est = transform_pts(points, pred_rots)
    points_tgt = transform_pts(points, gt_rots)
    if norm_by_extent:
        weights = (1.0 / extents.amax(dim=1).clamp_min(1e-6))[:, None, None]
    else:
        weights = 1.0

    def red(x, y):
        return _elem_loss(x, y, loss_type, beta).mean()

    out = {}
    if r_only:
        out["loss_PM_R"] = 3.0 * red(weights * points_est, weights * points_tgt) * loss_weight
        return out
    if disentangle_z:
        if t_loss_use_points:
            tgt_RT = points_tgt + gt_transes[:, None, :]
            est_R = points_est + gt_transes[:, None, :]
            pred_xy = torch.cat([pred_transes[:, :2], gt_transes[:, 2:3]], dim=1)
            est_xy = points_tgt + pred_xy[:, None, :]
            pred_z = torch.cat([gt_transes[:, :2], pred_transes[:, 2:3]], dim=1)
            est_z = points_tgt + pred_z[:, None, :]
            out["loss_PM_R"] = 3.0 * red(weights * est_R, weights * tgt_RT) * loss_weight
            out["loss_PM_xy"] = 3.0 * red(weights * est_xy, weights * tgt_RT) * loss_weight
            out["loss_PM_z"] = 3.0 * red(weights * est_z, weights * tgt_RT) * loss_weight
        else:
            out["loss_PM_R"] = 3.0 * red(weights * points_est, weights * points_tgt) * loss_weight
            out["loss_PM_xy_noP"] = red(pred_transes[:, :2], gt_transes[:, :2])
            out["loss_PM_z_noP"] = red(pred_transes[:, 2], gt_transes[:, 2])
    elif disentangle_t:
        if t_loss_use_points:
            tgt_RT = points_tgt + gt_transes[:, None, :]
            est_R = points_est + gt_transes[:, None, :]
            est_T = points_tgt + pred_transes[:, None, :]
            out["loss_PM_R"] = 3.0 * red(weights * est_R, weights * tgt_RT) * loss_weight
            out["loss_PM_T"] = 3.0 * red(weights * est_T, weights * tgt_RT) * loss_weight
        else:
            out["loss_PM_R"] = 3.0 * red(weights * points_est, weights * points_tgt) * loss_weight
            out["loss_PM_T_noP"] = red(pred_transes, gt_transes)
    else:
        est = points_est + pred_transes[:, None, :]
        tgt = points_tgt + gt_transes[:, None, :]
        out["loss_PM_RT"] = 3.0 * red(weights * est, weights * tgt) * loss_weight
    return out


def angular_rot_loss(pred_rots: torch.Tensor, gt_rots: torch.Tensor) -> torch.Tensor:
    """Reference angular_distance_rot (rot_loss.py:29-43): the smooth
    surrogate (1 - cos) / 2 with cos = (tr(R1 R2^T) - 1) / 2."""
    tr = (pred_rots * gt_rots).sum(dim=(-2, -1))
    return ((1.0 - (tr - 1.0) * 0.5) * 0.5).mean()


def compute_gdrn_losses(cfg, outputs: dict, batch: dict, sym_bank=None,
                        sym_mask=None, log_vars=None) -> dict:
    """The GDRN loss dict from the model's outputs and the batch's targets.

    outputs: vis_mask, full_mask (B, H, W), coor_x/y/z (B, H, W, C), region
    (B, H, W, R+1), rot_ego (B, 3, 3), trans (B, 3), centroid_rel (B, 2),
    z_rel (B,). batch: gt_xyz (B, H, W, 3) [or gt_xyz_bin int],
    gt_mask_trunc/visib/obj/full (B, H, W), gt_region (B, H, W) int, gt_rot,
    gt_trans, gt_trans_ratio (B, 3), gt_points (B, N, 3), roi_extents,
    roi_labels. log_vars: name -> learned log-variance (the model's
    ``log_vars`` output); with ``loss.use_mtl`` each loss_<name> becomes
    L exp(-a) + log(1 + exp(a)) (reference GDRN_double_mask.py:531-535).
    """
    lc = cfg.model.pose_net.loss
    if lc.use_mtl and log_vars is None:
        raise ValueError("loss.use_mtl weighs each term by the model's log_vars; none given")
    losses = {}
    gt_masks = {"trunc": batch["gt_mask_trunc"], "visib": batch["gt_mask_visib"],
                "obj": batch.get("gt_mask_obj"), "full": batch.get("gt_mask_full")}

    if not cfg.model.pose_net.geo_head.freeze:
        m_xyz = gt_masks[lc.xyz_loss_mask_gt]
        if lc.xyz_loss_type == "L1":
            for i, c in enumerate("xyz"):
                losses[f"loss_coor_{c}"] = masked_xyz_l1_loss(
                    outputs[f"coor_{c}"], batch["gt_xyz"][..., i:i + 1], m_xyz) * lc.xyz_lw
        elif lc.xyz_loss_type == "CE_coor":
            gt_bin = batch["gt_xyz_bin"]
            for i, c in enumerate("xyz"):
                losses[f"loss_coor_{c}"] = xyz_ce_loss(
                    outputs[f"coor_{c}"], gt_bin[..., i], m_xyz) * lc.xyz_lw
        else:
            raise NotImplementedError(lc.xyz_loss_type)

        losses["loss_mask"] = mask_loss(outputs["vis_mask"], gt_masks[lc.mask_loss_gt],
                                        lc.mask_loss_type) * lc.mask_lw
        if lc.full_mask_lw > 0 and outputs.get("full_mask") is not None:
            losses["loss_mask_full"] = mask_loss(
                outputs["full_mask"], batch["gt_mask_full"], lc.full_mask_loss_type) * lc.full_mask_lw

        if lc.region_lw > 0 and outputs["region"].shape[-1] > 0:
            if lc.region_loss_type != "CE":
                raise NotImplementedError(f"region_loss_type={lc.region_loss_type!r}: only CE")
            losses["loss_region"] = region_ce_loss(
                outputs["region"], batch["gt_region"],
                gt_masks[lc.region_loss_mask_gt]) * lc.region_lw

    if lc.pm_lw > 0:
        losses.update(point_matching_loss(
            pred_rots=outputs["rot_ego"], gt_rots=batch["gt_rot"], points=batch["gt_points"],
            pred_transes=outputs["trans"], gt_transes=batch["gt_trans"],
            extents=batch["roi_extents"], sym_bank=sym_bank, sym_mask=sym_mask,
            labels=batch["roi_labels"], loss_type=lc.pm_loss_type, beta=lc.pm_smooth_l1_beta,
            norm_by_extent=lc.pm_norm_by_extent, symmetric=lc.pm_loss_sym,
            r_only=lc.pm_r_only, disentangle_t=lc.pm_disentangle_t,
            disentangle_z=lc.pm_disentangle_z, t_loss_use_points=lc.pm_t_use_points,
            loss_weight=lc.pm_lw))

    if lc.rot_lw > 0:
        if lc.rot_loss_type == "angular":
            losses["loss_rot"] = angular_rot_loss(outputs["rot_ego"], batch["gt_rot"]) * lc.rot_lw
        else:
            losses["loss_rot"] = _elem_loss(outputs["rot_ego"], batch["gt_rot"],
                                            "mse").mean() * lc.rot_lw

    if lc.centroid_lw > 0 and cfg.model.pose_net.pnp_net.trans_type == "centroid_z":
        losses["loss_centroid"] = _reduced_loss(
            outputs["centroid_rel"], batch["gt_trans_ratio"][:, :2],
            lc.centroid_loss_type) * lc.centroid_lw
    if lc.z_lw > 0:
        gt_z = (batch["gt_trans_ratio"][:, 2] if cfg.model.pose_net.pnp_net.z_type == "REL"
                else batch["gt_trans"][:, 2])
        losses["loss_z"] = _reduced_loss(outputs["z_rel"][:, None], gt_z[:, None],
                                         lc.z_loss_type) * lc.z_lw

    if lc.trans_lw > 0:
        if lc.trans_loss_disentangle:
            losses["loss_trans_xy"] = _reduced_loss(
                outputs["trans"][:, :2], batch["gt_trans"][:, :2], lc.trans_loss_type) * lc.trans_lw
            losses["loss_trans_z"] = _reduced_loss(
                outputs["trans"][:, 2:3], batch["gt_trans"][:, 2:3], lc.trans_loss_type) * lc.trans_lw
        else:
            losses["loss_trans_LPnP"] = _reduced_loss(
                outputs["trans"], batch["gt_trans"], lc.trans_loss_type) * lc.trans_lw

    if lc.bind_lw > 0:
        pred_bind = torch.einsum("bji,bj->bi", outputs["rot_ego"], outputs["trans"])
        gt_bind = torch.einsum("bji,bj->bi", batch["gt_rot"], batch["gt_trans"])
        losses["loss_bind"] = _reduced_loss(pred_bind, gt_bind, lc.bind_loss_type) * lc.bind_lw

    if lc.use_mtl:
        for k in list(losses):
            lv = log_vars.get(k[len("loss_"):])
            if lv is not None:
                losses[k] = losses[k] * torch.exp(-lv) + torch.log1p(torch.exp(lv))
    return losses
