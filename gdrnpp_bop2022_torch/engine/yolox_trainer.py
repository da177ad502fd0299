"""YOLOX training on one card.

Port of ``gdrnpp_bop2022_tpu/engine/yolox_trainer.py`` (reference
det/yolox/engine/yolox_trainer.py: the iteration loop with EMA, resume
:207-224, the in-train eval with best-checkpoint tracking :226-283, the
switch that closes mosaic and turns the L1 loss on for the last
iterations :336-356, the random multiscale resize every 10 iterations
:413-416, the warmup-cosine schedule):

  DetRecords -> ``YoloxTrainLoader`` (one host thread: mosaic, mixup, HSV,
  flip) -> H2D -> ``multiscale_resize`` on the card -> ``make_yolox_train_step``
  (the bf16 forward with BatchNorm in training mode for ``norm="BN"``, the
  fp32 YOLOX loss with simOTA, the backward, clip-by-global-norm + Ranger or
  SGD with Nesterov, the EMA) -> ``metrics_yolox.json`` and checkpoints
  (``ckpt_yolox/``, ``ckpt_yolox_best/``).

The model starts from flax's default initialisers, as the JAX model does
(``init_yolox_weights``). The EMA averages the parameters only; BatchNorm's
running statistics live in the model's buffers (and its state dict), as
the JAX ``TrainState`` keeps ``batch_stats`` out of ``ema_params``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..models.yolox import build_yolox
from ..models.yolox.darknet import BatchNormFp32
from ..models.yolox.head import yolox_loss
from ..models.yolox.yolox import resize_bilinear
from ..solver.ranger import SGD, Ranger, output_unit_dims
from .checkpoint import CheckpointManager
from .train_state import create_train_state
from .trainer import StepTimer

# flax's lecun_normal: a normal truncated at 2 std, whose std this factor
# brings back to sqrt(1 / fan_in) (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def yolox_warmcos_schedule(base_lr: float, total_iters: int, warmup_iters: int,
                           warmup_lr_start: float = 0.0, min_lr_ratio: float = 0.05):
    """lr(step): a quadratic warmup from ``warmup_lr_start`` to ``base_lr``
    over ``warmup_iters``, then a cosine to ``min_lr_ratio * base_lr`` at
    ``total_iters``; in fp32 with the JAX schedule's operations."""
    f = np.float32

    def sched(step) -> float:
        x = f(step)
        warm = f(warmup_lr_start) + f(base_lr - warmup_lr_start) * np.square(
            x / f(max(warmup_iters, 1)))
        frac = np.clip((x - f(warmup_iters)) / f(max(total_iters - warmup_iters, 1)),
                       f(0), f(1))
        cos = f(base_lr) * (f(min_lr_ratio) + f(0.5 * (1 - min_lr_ratio))
                            * (f(1) + f(np.cos(np.float64(f(np.pi) * frac)))))
        return float(warm if x < warmup_iters else cos)

    return sched


@torch.no_grad()
def init_yolox_weights(model: torch.nn.Module, seed: int) -> None:
    """flax's default initialisers, as the JAX model starts: conv kernels
    lecun-normal (truncated at 2 std, std sqrt(1 / fan_in)), biases 0, norm
    scales 1 and biases 0, BatchNorm statistics 0 and 1, no prior bias on
    obj / cls. Drawn from a CPU ``torch.Generator`` seeded with ``seed``, so
    a seed gives the same weights on any device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            w = torch.empty(m.weight.shape)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (torch.nn.GroupNorm, torch.nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()


def build_yolox_optimizer(model: torch.nn.Module, schedule, optimizer: str = "sgd",
                          weight_decay: float = 5e-4, grad_clip: float = 35.0):
    """clip_by_global_norm(grad_clip) chained with Ranger (the BOP'22
    recipes: lr 1e-3 @ 64, wd 0) or with torch-style coupled weight decay
    on the parameters of more than one dim and SGD with Nesterov momentum
    0.9 (reference yolox_base.py:118-127)."""
    chain = dict(clip_grad_norm=grad_clip, unit_dims=output_unit_dims(model))
    params = list(model.parameters())
    if optimizer == "ranger":
        return Ranger(params, schedule, weight_decay=weight_decay, **chain)
    if optimizer == "sgd":
        return SGD(params, schedule, momentum=0.9, nesterov=True, weight_decay=weight_decay,
                   **chain)
    raise ValueError(f"unknown yolox optimizer {optimizer}")


def make_yolox_train_step(strides=(8, 16, 32), use_l1: bool = False):
    """train_step(state, batch, timer=None) -> metrics (0-d tensors on the
    device); advances the state in place. batch: images (B, S, S, 3) (any
    dtype, taken as fp32), gt_boxes (B, G, 4) cxcywh, gt_labels (B, G),
    gt_valid (B, G). The model runs in training mode (BatchNorm updates its
    running statistics). ``timer.mark`` after the backward ("fwd_bwd") and
    after the optimizer and EMA ("opt_ema")."""

    def train_step(state, batch: dict, timer=None) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outs = model(batch["images"].float())
        losses = yolox_loss(outs, strides, batch["gt_boxes"], batch["gt_labels"],
                            batch["gt_valid"], use_l1=use_l1)
        losses["total_loss"].backward()
        if timer is not None:
            timer.mark("fwd_bwd")
        if state.optimizer.step():
            state.update_ema()
        state.step += 1
        if timer is not None:
            timer.mark("opt_ema")
        return {k: v.detach() for k, v in losses.items()}

    return train_step


@torch.no_grad()
def precise_bn_stats(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
                     image_batches: Iterable) -> Dict[str, torch.Tensor]:
    """BatchNorm running statistics as the true average over the batches
    (reference fvcore PreciseBN hook, yolox_trainer.py:242-250) of each
    batch's biased mean and variance at every BN, from training-mode
    forwards with ``weights`` (a dict of parameters, the EMA in the trainer):
    at momentum 1 / k the k-th batch's update leaves the running average of
    the k batches. Returns {"<bn>.running_mean" / "<bn>.running_var": tensor},
    empty without batches; the model's own buffers are restored."""
    bns = [m for m in model.modules() if isinstance(m, BatchNormFp32)]
    momenta = [m.momentum for m in bns]
    saved = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    was_training = model.training
    device = next(model.parameters()).device
    model.train()
    n = 0
    try:
        for imgs in image_batches:
            n += 1
            for m in bns:
                m.momentum = 1.0 / n
            torch.func.functional_call(model, weights, (torch.as_tensor(imgs).to(device).float(),))
        out = {k: v.clone() for k, v in model.state_dict().items()
               if n and k.endswith(("running_mean", "running_var"))}
    finally:
        for m, momentum in zip(bns, momenta):
            m.momentum = momentum
        model.load_state_dict(saved, strict=False)
        model.train(was_training)
    return out


def multiscale_resize(images: torch.Tensor, boxes: torch.Tensor, size: int):
    """The batch bilinearly resized to (size, size) (``resize_bilinear``:
    ``jax.image.resize``'s bilinear) and its boxes scaled by size / S
    (reference yolox_trainer.py:413-416). images (B, S, S, 3), boxes
    (B, G, 4)."""
    S = images.shape[1]
    if size == S:
        return images, boxes
    return resize_bilinear(images, size, size), boxes * (size / S)


def _eval_weights(state) -> Dict[str, torch.Tensor]:
    """The EMA parameters with the model's buffers (BN statistics): the
    model the in-train eval runs."""
    sd = state.model.state_dict()
    sd.update(state.ema_state_dict())
    return sd


def train_yolox(records, num_classes: int, output_dir: str,
                size: str = "yolox_x", input_size: int = 640,
                batch_size: int = 16, total_iters: int = 1000,
                base_lr: float = 0.01 / 64, weight_decay: float = 5e-4,
                optimizer: str = "sgd",
                warmup_iters: Optional[int] = None,
                grad_clip: float = 35.0,
                aug: Optional[dict] = None,
                no_aug_iters: int = 0,
                log_period: int = 20, ckpt_period: int = 500,
                seed: int = 0, loader=None,
                eval_fn: Optional[Callable] = None,
                eval_period: int = 0,
                multiscale_range: int = 0,
                multiscale_period: int = 10,
                random_size: Optional[tuple] = None,
                ema_decay: float = 0.9998,
                norm: str = "GN",
                precise_bn_iters: int = 0,
                device="cuda", stats: Optional[dict] = None):
    """Train YOLOX on DetRecords on ``device`` (the card unless the caller
    asks for the CPU; bf16 convolutions on the card, fp32 on the CPU).
    Returns the TrainState; resumes from the newest checkpoint in
    ``output_dir/ckpt_yolox`` where there is one.

    ``eval_fn(weights, iteration) -> metrics dict`` is called with the EMA
    weights (a state dict: EMA parameters and the BN statistics) every
    ``eval_period`` iterations and at the end, after ``precise_bn_iters``
    clean batches have recomputed the BN statistics (``norm="BN"``); the
    best AP50 keeps its checkpoint in ``ckpt_yolox_best/`` and its
    value in ``best_val.json``, inherited only by a resumed run.
    ``random_size=(lo, hi)``: a square size drawn from [lo, hi] x 32 every
    ``multiscale_period`` iterations (the reference's exp.random_size); else
    ``multiscale_range=N``: input_size +- N x 32. The last ``no_aug_iters``
    iterations train without mosaic and mixup, with the L1 loss, at
    ``input_size``. With ``stats`` (a dict): per-step CUDA-event times of
    each phase (h2d, resize, fwd_bwd, opt_ema, step; on the card) and the
    host's waits on the loader (ms)."""
    from ..datasets.yolox_loader import YoloxTrainLoader

    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_yolox(num_classes, size, norm=norm, device=device, dtype=dtype)
    init_yolox_weights(model, seed)
    model.train()
    if loader is None:
        loader = YoloxTrainLoader(records, batch_size, input_size, seed=seed, **(aug or {}))

    sched = yolox_warmcos_schedule(
        base_lr * batch_size, total_iters,
        warmup_iters=(min(500, total_iters // 10) if warmup_iters is None
                      else min(warmup_iters, total_iters)))
    state = create_train_state(
        model, build_yolox_optimizer(model, sched, optimizer, weight_decay, grad_clip),
        ema_decay=ema_decay)
    ckpt = CheckpointManager(os.path.join(output_dir, "ckpt_yolox"))
    best_ckpt = CheckpointManager(os.path.join(output_dir, "ckpt_yolox_best"), max_to_keep=1)
    if ckpt.restore_latest(state) is not None:
        print(f"yolox: resumed from iter {state.step}", flush=True)
    start_iter = state.step

    with_bs = norm == "BN"
    step_aug = make_yolox_train_step(model.strides, use_l1=False)
    step_noaug = make_yolox_train_step(model.strides, use_l1=True)
    timer = StepTimer(enabled=stats is not None and device.type == "cuda")
    waits = []

    os.makedirs(output_dir, exist_ok=True)
    metrics_path = os.path.join(output_dir, "metrics_yolox.json")
    ms_rng = np.random.RandomState(seed + 2)
    best_val_path = os.path.join(output_dir, "best_val.json")
    best_val = -np.inf
    # a fresh run in a reused output directory starts clean
    if start_iter > 0 and os.path.exists(best_val_path):
        with open(best_val_path) as f:
            best_val = float(json.load(f)["best"])
    cur_size = input_size
    t0 = time.perf_counter()
    try:
        t_w = time.perf_counter()
        host_batch = next(loader)
        waits.append(time.perf_counter() - t_w)
        for it in range(start_iter, total_iters):
            in_noaug = it >= total_iters - no_aug_iters
            if in_noaug and loader.enable_aug:
                # close mosaic, L1 on (reference yolox_trainer.py:336-356)
                loader.mosaic_prob = 0.0
                loader.mixup_prob = 0.0
                loader.enable_aug = False
            step_fn = step_noaug if in_noaug else step_aug
            if ((random_size is not None or multiscale_range > 0)
                    and it % multiscale_period == 0):
                # the no-aug phase trains at the eval size
                if in_noaug:
                    cur_size = input_size
                elif random_size is not None:
                    cur_size = 32 * ms_rng.randint(random_size[0], random_size[1] + 1)
                else:
                    cur_size = 32 * ms_rng.randint(input_size // 32 - multiscale_range,
                                                   input_size // 32 + multiscale_range + 1)
            timer.begin()
            batch = {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()}
            timer.mark("h2d")
            if cur_size != input_size:
                batch["images"], batch["gt_boxes"] = multiscale_resize(
                    batch["images"], batch["gt_boxes"], cur_size)
            timer.mark("resize")
            metrics = step_fn(state, batch, timer)
            if (it + 1) % log_period == 0 or it == start_iter:
                row = {k: float(v) for k, v in metrics.items()}
                row["iteration"] = it + 1
                row["img_size"] = cur_size
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                done = it + 1 - start_iter
                eta = (time.perf_counter() - t0) / done * (total_iters - it - 1)
                print(f"yolox iter {it + 1}/{total_iters} loss {row['total_loss']:.3f} "
                      f"size {cur_size} eta {eta / 60:.1f}min", flush=True)
            if (it + 1) % ckpt_period == 0 or (it + 1) == total_iters:
                ckpt.save(state, it + 1)
            if (eval_fn is not None and eval_period > 0
                    and ((it + 1) % eval_period == 0 or (it + 1) == total_iters)):
                if with_bs and precise_bn_iters > 0:
                    # BN statistics recomputed over clean train batches with
                    # the EMA weights, the model the eval runs (reference
                    # PreciseBN hook, yolox_trainer.py:242-250)
                    bn = precise_bn_stats(
                        model, state.ema_state_dict(),
                        (next(loader)["images"] for _ in range(precise_bn_iters)))
                    model.load_state_dict(bn, strict=False)
                val_metrics = eval_fn(_eval_weights(state), it + 1)
                row = {f"val/{k_}": float(v) for k_, v in val_metrics.items()}
                row["iteration"] = it + 1
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
                val = float(val_metrics.get("AP50", -np.inf))
                if val > best_val:
                    best_val = val
                    with open(best_val_path, "w") as f:
                        json.dump({"best": best_val, "iteration": it + 1}, f)
                    best_ckpt.save(state, it + 1)
                    print(f"yolox eval @ {it + 1}: AP50={val:.4f} (new best)", flush=True)
                else:
                    print(f"yolox eval @ {it + 1}: AP50={val:.4f} "
                          f"(best {best_val:.4f})", flush=True)
            if it + 1 < total_iters:
                t_w = time.perf_counter()
                host_batch = next(loader)
                waits.append(time.perf_counter() - t_w)
    finally:
        loader.close()
    if stats is not None:
        stats.update(timer.summary())
        stats["host_wait"] = [1e3 * w for w in waits]
    return state
