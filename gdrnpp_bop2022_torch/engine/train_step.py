"""Train and eval steps for GDRN.

Port of ``gdrnpp_bop2022_tpu/engine/train_step.py`` (reference
engine.py:284-343: forward, loss reduce, backward, optimizer, EMA). A train
step runs the model in train mode, the GDRN loss dict, backward (kernel
B1's backward for every ConvNeXt LayerNorm on the card), the optimizer and
the EMA, and returns its metrics as 0-d tensors on the device: the loss
dict, ``total_loss``, ``error_R_deg`` and ``error_t_cm``. Nothing in it
reads a value back to the host.
"""

from __future__ import annotations

import math

import torch

from ..geometry.rotations import angular_distance
from ..losses.gdrn_losses import compute_gdrn_losses
from ..parallel.distributed import sync_grads

MODEL_INPUTS = ("roi_img", "roi_labels", "roi_coord_2d", "roi_cams", "roi_centers",
                "roi_whs", "roi_extents", "resize_ratios")


def model_inputs(batch: dict) -> dict:
    """The batch entries GDRN.forward takes."""
    kw = {k: batch[k] for k in MODEL_INPUTS}
    if batch.get("roi_depth") is not None:
        kw["roi_depth"] = batch["roi_depth"]
    return kw


def forward_outputs(model, batch: dict, drop=None, progress: float = 1.0) -> dict:
    """The model on the batch; ``drop`` (a ``models.layers.DropMasks``) and
    ``progress`` feed drop_path and DropBlock in training."""
    return model(**model_inputs(batch), drop=drop, progress=progress)


def loss_and_metrics(cfg, outputs: dict, batch: dict, sym_bank=None, sym_mask=None):
    """(total loss, metrics dict) of one forward's outputs."""
    out_for_loss = {"vis_mask": outputs["vis_mask"], "full_mask": outputs["full_mask"],
                    "coor_x": outputs["coor_x"], "coor_y": outputs["coor_y"],
                    "coor_z": outputs["coor_z"], "region": outputs["region"],
                    "rot_ego": outputs["rot"], "trans": outputs["trans"],
                    "centroid_rel": outputs["centroid_rel"], "z_rel": outputs["z_rel"]}
    losses = compute_gdrn_losses(cfg, out_for_loss, batch, sym_bank=sym_bank,
                                 sym_mask=sym_mask, log_vars=outputs.get("log_vars"))
    total = sum(losses.values())
    metrics = dict(losses)
    metrics["total_loss"] = total
    # train-time pose error (reference compute_mean_re_te)
    metrics["error_R_deg"] = angular_distance(outputs["rot"], batch["gt_rot"]).mean() * (
        180.0 / math.pi)
    metrics["error_t_cm"] = torch.linalg.vector_norm(
        outputs["trans"] - batch["gt_trans"], dim=-1).mean() * 100.0
    return total, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, sym_bank=None, sym_mask=None):
    """train_step(state, batch, timer=None, drop=None, progress=1.0) ->
    metrics; advances state in place (params, optimizer state, EMA, step).
    ``drop`` and ``progress`` feed drop_path and DropBlock (``progress``:
    the share of the run done). The EMA advances with each optimizer update
    (every step, or every k-th with ``solver.grad_accum_steps`` k).
    ``timer.mark(name)``, when given, is called after the backward
    ("fwd_bwd") and after the optimizer and EMA ("opt_ema"). Under data
    parallelism ``batch`` is the rank's slice and the gradients are
    averaged over the ranks before the optimizer (its clipping included);
    the metrics are the rank's (``parallel.mean_over_ranks`` gives the
    global batch's)."""

    def train_step(state, batch: dict, timer=None, drop=None, progress: float = 1.0) -> dict:
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outputs = forward_outputs(model, batch, drop, progress)
        total, metrics = loss_and_metrics(cfg, outputs, batch, sym_bank, sym_mask)
        total.backward()
        sync_grads(model.parameters())
        if timer is not None:
            timer.mark("fwd_bwd")
        if state.optimizer.step():
            state.update_ema()
        state.step += 1
        if timer is not None:
            timer.mark("opt_ema")
        return metrics

    return train_step


def make_eval_step(use_ema: bool = True):
    """eval_step(state, batch) -> outputs dict (poses and dense maps) of the
    model in eval mode, with the EMA weights unless use_ema is False."""

    def eval_step(state, batch: dict) -> dict:
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                if use_ema:
                    return torch.func.functional_call(model, state.ema_state_dict(), (),
                                                      model_inputs(batch))
                return forward_outputs(model, batch)
        finally:
            model.train(was_training)

    return eval_step
