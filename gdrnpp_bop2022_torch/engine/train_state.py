"""Train state: the model, its optimizer, the EMA weights and the step count.

Port of ``gdrnpp_bop2022_tpu/engine/train_state.py``. The EMA follows the
reference ramp ``decay * (1 - exp(-updates / warmup))``
(lib/torch_utils/torch_utils.py:225): an fp32 copy of every parameter,
updated after each optimizer update with two ``torch._foreach_*`` ops, its
ramp counting the optimizer's updates (with ``solver.grad_accum_steps`` k,
one per k steps). The ramp's scalar is computed on the host in fp32, as the
JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch


def ema_decay_at(updates_count: int, decay: float = 0.9999, warmup: float = 2000.0):
    """(d, 1 - d) of the EMA after ``updates_count`` updates, fp32 values."""
    d = decay * (1.0 - torch.exp(-torch.tensor(float(updates_count)) / warmup))
    return float(d), float(1.0 - d)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], updates_count: int,
               decay: float = 0.9999, warmup: float = 2000.0) -> None:
    """In place: ema = ema * d + (1 - d) * params."""
    d, one_minus_d = ema_decay_at(updates_count, decay, warmup)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=one_minus_d)


@dataclass
class TrainState:
    """What a step changes and a checkpoint keeps. ``ema`` holds one fp32
    tensor per ``model.named_parameters()`` entry, in that order;
    ``generators`` the trainer's random streams by purpose (augmentations,
    dropout masks). ``step`` counts train steps."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: List[torch.Tensor] = field(default_factory=list)
    step: int = 0
    ema_decay: float = 0.9999
    ema_warmup: float = 2000.0
    generators: Dict[str, torch.Generator] = field(default_factory=dict)

    def param_names(self) -> List[str]:
        return [n for n, _ in self.model.named_parameters()]

    def ema_state_dict(self) -> dict:
        return dict(zip(self.param_names(), self.ema))

    def update_ema(self) -> None:
        """After an optimizer update; the ramp counts the optimizer's updates."""
        ema_update(self.ema, list(self.model.parameters()),
                   self.optimizer.param_groups[0]["count"], self.ema_decay, self.ema_warmup)


def create_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       ema_decay: float = 0.9999, ema_warmup: float = 2000.0) -> TrainState:
    """Step 0, EMA = an fp32 copy of the parameters."""
    ema = [p.detach().float().clone() for p in model.parameters()]
    return TrainState(model=model, optimizer=optimizer, ema=ema, step=0,
                      ema_decay=ema_decay, ema_warmup=ema_warmup)
