"""Learning-rate schedules, evaluated on the host once per step.

Port of ``gdrnpp_bop2022_tpu/solver/lr_scheduler.py``. The GDRNPP recipe is
"flat and anneal" (reference lib/torch_utils/solver/lr_scheduler.py:148-260):
warmup, flat at base_lr until anneal_point of training, then anneal
(cosine by default) to target_lr_factor * base_lr. A schedule maps the step
(0-based) to a Python float; it reads nothing from the device. The
arithmetic is fp32 in the JAX package's order of operations (CPU tensors),
so the two agree to fp32 rounding, also where ``1 + cos`` cancels near the
end of the anneal.
"""

from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def flat_and_anneal_schedule(base_lr: float, total_iters: int, warmup_iters: int = 0,
                             warmup_factor: float = 0.1, warmup_method: str = "linear",
                             warmup_pow: float = 2.0, anneal_point: float = 0.72,
                             anneal_method: str = "cosine", target_lr_factor: float = 0.0,
                             poly_power: float = 1.0):
    """Returns schedule(step) -> lr (float). Warmup methods: linear, pow,
    exp, constant; anneal methods: cosine, linear, poly, exp, none."""
    if warmup_method not in ("linear", "pow", "exp", "constant"):
        raise ValueError(f"unknown warmup method {warmup_method}")
    if anneal_method not in ("cosine", "linear", "poly", "exp", "none"):
        raise ValueError(f"unknown anneal method {anneal_method}")
    total_iters = max(int(total_iters), 1)
    anneal_start = anneal_point * total_iters

    def schedule(step) -> float:
        x = _f32(float(step))
        if x < warmup_iters:
            alpha = x / max(warmup_iters, 1)
            if warmup_method == "linear":
                f = (1.0 - warmup_factor) * alpha + warmup_factor
            elif warmup_method == "pow":
                f = (1.0 - warmup_factor) * torch.pow(alpha, warmup_pow) + warmup_factor
            elif warmup_method == "exp":
                f = torch.pow(_f32(warmup_factor), 1.0 - alpha)
            else:
                f = _f32(warmup_factor)
        elif x < anneal_start:
            f = _f32(1.0)
        else:
            frac = torch.clamp((x - anneal_start) / max(total_iters - anneal_start, 1e-8),
                               0.0, 1.0)
            t = target_lr_factor
            if anneal_method == "cosine":
                f = t + 0.5 * (1.0 - t) * (1.0 + torch.cos(math.pi * frac))
            elif anneal_method == "linear":
                f = t + (1.0 - t) * (1.0 - frac)
            elif anneal_method == "poly":
                f = t + (1.0 - t) * torch.pow(1.0 - frac, poly_power)
            elif anneal_method == "exp":
                f = torch.pow(_f32(max(t, 1e-8)), frac)
            else:
                f = _f32(1.0)
        return float(base_lr * f)

    return schedule


def build_lr_scheduler(cfg, iters_per_epoch: int):
    """Schedule from the SolverConfig over total_epochs * iters_per_epoch
    steps (reference solver_utils.py:134-160): flat_and_anneal | constant."""
    sc = cfg.solver
    if sc.lr_scheduler == "flat_and_anneal":
        return flat_and_anneal_schedule(
            base_lr=sc.base_lr, total_iters=sc.total_epochs * iters_per_epoch,
            warmup_iters=sc.warmup_iters, warmup_factor=sc.warmup_factor,
            warmup_method=sc.warmup_method, anneal_point=sc.anneal_point,
            anneal_method=sc.anneal_method)
    if sc.lr_scheduler == "constant":
        return lambda step: float(_f32(sc.base_lr))
    raise ValueError(f"unknown lr scheduler {sc.lr_scheduler}")
