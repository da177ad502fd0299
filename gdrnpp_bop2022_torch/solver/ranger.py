"""Optimizers of the GDRN recipe: Ranger (RAdam + Lookahead + gradient
centralization), RangerAdaBelief, Adam, AdamW and SGD, as one
``torch.optim.Optimizer`` family that updates whole parameter lists with
``torch._foreach_*`` ops; the rest of the JAX package's zoo is in
``solver/optimizers.py`` on the same base.

Port of ``gdrnpp_bop2022_tpu/solver/ranger.py`` (``ranger``,
``build_optimizer``, ``scale_updates_by_module``; reference
lib/torch_utils/solver/ranger.py) and of the optax transformations it
chains. One ``step()`` applies, in the JAX package's order:

  0. with ``solver.grad_accum_steps`` k > 1 (optax.MultiSteps): the
     gradients go into a running mean, (g + n acc) / (n + 1); only every
     k-th step runs 1-4 on that mean (and the trainer's EMA then advances),
     the others change no parameter and return False;
  1. NaN/inf gradients to 0 (``solver.nan_grad_to_zero``), as
     ``where(isfinite(g), g, 0)``;
  2. clipping by the global norm (``solver.clip_grad_norm`` > 0): scaled by
     max_norm / norm only when norm > max_norm (optax.clip_by_global_norm);
  3. the optimizer's update, with the learning rate of ``schedule(count - 1)``
     (the first update uses step 0's rate, as optax does);
  4. the update times its parameter group's ``lr_mult`` (geo head, PnP net),
     then added to the parameters.

Parameters are taken in blocks of one group and one (shape, dtype, device,
output-unit dim): ConvNeXt-base GDRN's 380 parameters make 33 blocks. Each
step stacks a block's gradients and parameters into one (n, *shape) tensor,
and the optimizer state lives stacked the same way (``state[p][name]`` is a
view into it), so every pass of the chain and of the update is one op per
block, or one ``_foreach_`` op over the blocks, rather than one per
parameter. Only the last pass, adding the updates to the parameters, is a
``_foreach_`` op over every parameter.

The step count and the learning rate live on the host; the RAdam and bias
correction scalars are computed from them in fp32 in the JAX package's order
of operations (RAdam's n_sma cancels in fp32: 0.974 at step 1, not 1.0), so
nothing in a step waits on the device.

Gradient centralization follows the JAX package, which centralizes over
axes 1.. of the flax layout. Mapped onto torch layouts that is: 4-D conv
(O, I, kh, kw) and ConvTranspose (I, O, kh, kw) weights over every dim but
2; 2-D linear (O, I) weights over dim 0; 1-D tensors not at all. (The
reference's torch Ranger keeps dim 0 of the torch layout instead.) What the
JAX package computes per output unit (the last flax axis) is per dim 0 of a
conv or linear weight and dim 1 of a ConvTranspose weight here
(``unit_dims``).
"""

from __future__ import annotations

import torch

# dims a gradient is centralized over, by ndim (see the module docstring)
GC_DIMS = {2: (0,), 4: (0, 1, 3)}


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def radam_scalars(count: int, b1: float, b2: float, n_sma_threshold: float = 5.0):
    """(use_var, rect, plain) of RAdam's step ``count`` (1-based), fp32."""
    t = _f32(float(count))
    beta2_t = torch.pow(_f32(b2), t)
    n_sma_max = 2.0 / (1.0 - b2) - 1.0
    n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
    bias1 = 1.0 - torch.pow(_f32(b1), t)
    rect = torch.sqrt(torch.clamp_min(
        (1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0) * (n_sma - 2.0)
        / torch.clamp_min(n_sma, 1e-8) * n_sma_max / (n_sma_max - 2.0), 0.0)) / bias1
    plain = 1.0 / bias1
    return bool(n_sma > n_sma_threshold), float(rect), float(plain)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in fp32 (optax's bias_correction)."""
    return float(1.0 - torch.pow(_f32(decay), _f32(float(count))))


class ChainedOptimizer(torch.optim.Optimizer):
    """The chain around an optimizer's update (NaN to 0, global-norm clip,
    per-group lr_mult). Subclasses implement ``_updates`` on stacks: one
    (n, *shape) tensor per block of parameters of one group and one (shape,
    dtype, device). Every group has ``lr_mult`` and a ``count`` of steps
    taken. ``state[p][name]`` is a view into its block's stacked state."""

    def __init__(self, params, schedule, nan_grad_to_zero: bool = False,
                 clip_grad_norm: float = 0.0, accum_steps: int = 1, unit_dims=None):
        """unit_dims: id(parameter) -> the dim of its output unit (0 when
        absent), see ``output_unit_dims``."""
        if callable(schedule):
            self.schedule = schedule
        else:
            rate = float(schedule)
            self.schedule = lambda step: rate
        self.nan_grad_to_zero = nan_grad_to_zero
        self.clip_grad_norm = clip_grad_norm
        self.accum_steps = accum_steps
        self._unit_dims = dict(unit_dims or {})
        self._layout = (None, [])    # (parameter ids, blocks)
        self._stacked = {}           # (state name, block index) -> (n, *shape) tensor
        super().__init__(params, {"lr_mult": 1.0, "count": 0, "mini_step": 0})

    def unit_dim(self, p) -> int:
        return self._unit_dims.get(id(p), 0)

    def _blocks(self):
        """[(group, [params])], one entry per (group, shape, dtype, device,
        unit dim), in parameter order; recomputed when the parameters
        change."""
        key = tuple(id(p) for g in self.param_groups for p in g["params"])
        if self._layout[0] != key:
            blocks = []
            for group in self.param_groups:
                by_shape = {}
                for p in group["params"]:
                    k = (p.shape, p.dtype, p.device, self.unit_dim(p))
                    by_shape.setdefault(k, []).append(p)
                blocks += [(group, ps) for ps in by_shape.values()]
            self._layout = (key, blocks)
            self._stacked = {}
        return self._layout[1]

    @staticmethod
    def _stacked_grads(blocks):
        """The gradients stacked per block (zeros where a parameter has
        none). ``p.grad`` itself is left as it is."""
        stacks = []
        for _, ps in blocks:
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            stacks.append(torch.stack([p.grad for p in ps]))
        return stacks

    def _grads(self, stacks):
        """The chain on stacked gradients: NaN-to-zero'd, clipped and
        ``_precondition``-ed (in place where it can)."""
        if self.nan_grad_to_zero:
            stacks = [torch.where(torch.isfinite(s), s, 0.0) for s in stacks]
        if self.clip_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(stacks)))
            scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            torch._foreach_mul_(stacks, scale)
        self._precondition(stacks)
        return stacks

    def _precondition(self, stacks):
        """In place on the stacked gradients, before the update; nothing by
        default."""

    def _state(self, blocks, params, name, init):
        """State ``name`` stacked per block: built from the per-parameter
        tensors where every parameter of the block has them (a state loaded
        by ``load_state_dict``), else ``init(stacked params)``; each
        ``state[p][name]`` then becomes a view into it."""
        out = []
        for b, ((_, ps), P) in enumerate(zip(blocks, params)):
            buf = self._stacked.get((name, b))
            if buf is None:
                have = [self.state[p].get(name) for p in ps]
                buf = (torch.stack(have) if all(t is not None for t in have)
                       else init(P))
                for p, v in zip(ps, buf.unbind(0)):
                    self.state[p][name] = v
                self._stacked[(name, b)] = buf
            out.append(buf)
        return out

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self._stacked = {}          # restacked from the loaded state at the next step

    def _updates(self, blocks, params, grads, count: int, lr: float):
        raise NotImplementedError

    def _set_groups(self, key, value):
        for group in self.param_groups:
            group[key] = value

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        """One optimizer step; True when it updated the parameters (always,
        unless gradients are being accumulated)."""
        if closure is not None:
            raise ValueError("closures are not supported")
        blocks = self._blocks()
        if not blocks:
            return False
        grads = self._stacked_grads(blocks)
        if self.accum_steps > 1:
            n = self.param_groups[0].get("mini_step", 0)
            acc = self._state(blocks, grads, "acc_grad", torch.zeros_like)
            for a, g in zip(acc, grads):
                a.mul_(n).add_(g).div_(n + 1)
            if n + 1 < self.accum_steps:
                self._set_groups("mini_step", n + 1)
                return False
            self._set_groups("mini_step", 0)
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        grads = self._grads(grads)
        params = [torch.stack(ps) for _, ps in blocks]
        count = self.param_groups[0]["count"] + 1
        updates = self._updates(blocks, params, grads, count, self.schedule(count - 1))
        for (group, _), u in zip(blocks, updates):
            if group["lr_mult"] != 1.0:
                u.mul_(group["lr_mult"])
        self._set_groups("count", count)
        torch._foreach_add_([p for _, ps in blocks for p in ps],
                            [v for u in updates for v in u.unbind(0)])
        return True


class Ranger(ChainedOptimizer):
    """Ranger, or RangerAdaBelief with ``belief=True`` (the second moment of
    (g - m) instead of g). State per parameter: exp_avg, exp_avg_sq and the
    lookahead's slow weights (a copy of the parameter at the first step)."""

    def __init__(self, params, schedule, alpha: float = 0.5, k: int = 6,
                 n_sma_threshold: float = 5.0, betas=(0.95, 0.999), eps: float = 1e-5,
                 weight_decay: float = 0.0, use_gc: bool = True, gc_conv_only: bool = False,
                 belief: bool = False, **chain):
        self.alpha, self.k, self.n_sma_threshold = alpha, k, n_sma_threshold
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.use_gc, self.belief = use_gc, belief
        self.gc_min_ndim = 4 if gc_conv_only else 2
        super().__init__(params, schedule, **chain)

    def _precondition(self, stacks):
        """Gradient centralization, one mean and one subtraction per block."""
        if not self.use_gc:
            return
        for s in stacks:
            nd = s.ndim - 1
            if nd >= self.gc_min_ndim:
                if nd not in GC_DIMS:
                    raise ValueError(f"no gradient-centralization layout for a {nd}-D tensor")
                s.sub_(s.mean(dim=tuple(d + 1 for d in GC_DIMS[nd]), keepdim=True))

    def _updates(self, blocks, params, grads, count, lr):
        b1, b2 = self.betas
        m = self._state(blocks, params, "exp_avg", torch.zeros_like)
        v = self._state(blocks, params, "exp_avg_sq", torch.zeros_like)
        slow = self._state(blocks, params, "slow", torch.clone)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        if self.belief:
            d = torch._foreach_sub(grads, m)
            torch._foreach_addcmul_(v, d, d, value=1.0 - b2)
        else:
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        use_var, rect, plain = radam_scalars(count, b1, b2, self.n_sma_threshold)
        if use_var:
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(m, denom)
            torch._foreach_mul_(step, rect)
        else:
            step = torch._foreach_mul(m, plain)
        if self.weight_decay != 0.0:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_mul_(step, -lr)
        fast = torch._foreach_add(params, step)
        if count % self.k == 0:          # lookahead: slow += alpha (fast - slow)
            torch._foreach_add_(slow, torch._foreach_sub(fast, slow), alpha=self.alpha)
            fast = slow
        return torch._foreach_sub(fast, params)


class Adam(ChainedOptimizer):
    """optax.adam (eps 1e-8) or, with decoupled ``weight_decay``, optax.adamw.
    State: exp_avg, exp_avg_sq."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, **chain):
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        b1, b2 = self.betas
        m = self._state(blocks, params, "exp_avg", torch.zeros_like)
        v = self._state(blocks, params, "exp_avg_sq", torch.zeros_like)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        m_hat = torch._foreach_div(m, _bias_correction(b1, count))
        denom = torch._foreach_div(v, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(m_hat, denom)
        if self.weight_decay != 0.0:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_mul_(step, -lr)
        return step


class SGD(ChainedOptimizer):
    """optax.sgd: with momentum, trace = g + momentum * trace and the update
    -lr trace, or with ``nesterov`` -lr (g + momentum * trace). With
    ``weight_decay``, first g += weight_decay * p for the parameters of more
    than one dim (``optax.add_decayed_weights`` under the YOLOX SGD recipe's
    mask ``ndim > 1``: no decay on norm scales and biases). State:
    momentum_buffer."""

    def __init__(self, params, schedule, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, **chain):
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        if self.weight_decay:
            for g, P in zip(grads, params):
                if P.ndim > 2:              # a stack of parameters of more than one dim
                    g.add_(P, alpha=self.weight_decay)
        if self.momentum:
            buf = self._state(blocks, params, "momentum_buffer", torch.zeros_like)
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, grads)
            if self.nesterov:
                grads = torch._foreach_add(grads, buf, alpha=self.momentum)
            else:
                grads = buf
        return torch._foreach_mul(grads, -lr)


def param_groups(model: torch.nn.Module, lr_mults: dict) -> list:
    """The model's parameters in groups by name prefix, each with its
    lr_mult (names under no prefix of ``lr_mults`` get 1.0)."""
    groups = {prefix: [] for prefix in lr_mults}
    rest = []
    for name, p in model.named_parameters():
        key = next((k for k in lr_mults if name.startswith(k)), None)
        (groups[key] if key is not None else rest).append(p)
    out = [{"params": rest, "lr_mult": 1.0}] if rest else []
    out += [{"params": ps, "lr_mult": lr_mults[k]} for k, ps in groups.items() if ps]
    return out


def output_unit_dims(model: torch.nn.Module) -> dict:
    """id(parameter) -> the dim of its output unit, for the parameters
    whose unit is not dim 0: ConvTranspose weights (I, O, kh, kw)."""
    return {id(m.weight): 1 for m in model.modules()
            if isinstance(m, torch.nn.ConvTranspose2d)}


def build_optimizer(cfg, lr_schedule, model: torch.nn.Module) -> ChainedOptimizer:
    """The optimizer of ``cfg.solver`` for ``model`` (reference
    core/utils/solver_utils.py:28-110): ranger | ranger_adabelief | ranger21
    | adam | adamw | sgd | sgd_gc | adamp | sgdp | adabelief | madgrad | lamb
    | radam, chained with NaN-to-zero, clipping and the geo head's and PnP
    net's lr_mult, with ``solver.grad_accum_steps`` micro-steps per update."""
    from . import optimizers as zoo
    sc = cfg.solver
    pc = cfg.model.pose_net
    lr_mults = {}
    if pc.geo_head.lr_mult != 1.0:
        lr_mults["geo_head_net."] = pc.geo_head.lr_mult
    if pc.pnp_net.lr_mult != 1.0:
        lr_mults["pnp_net."] = pc.pnp_net.lr_mult
    groups = param_groups(model, lr_mults)
    chain = dict(nan_grad_to_zero=sc.nan_grad_to_zero, clip_grad_norm=sc.clip_grad_norm,
                 accum_steps=sc.grad_accum_steps, unit_dims=output_unit_dims(model))
    wd, mom = sc.weight_decay, sc.momentum
    build = {
        "ranger": lambda: Ranger(groups, lr_schedule, weight_decay=wd, **chain),
        "rangeradabelief": lambda: Ranger(groups, lr_schedule, weight_decay=wd, belief=True,
                                          **chain),
        "ranger21": lambda: zoo.Ranger21(groups, lr_schedule, weight_decay=wd, **chain),
        "adamp": lambda: zoo.AdamP(groups, lr_schedule, weight_decay=wd, **chain),
        "sgdp": lambda: zoo.SGDP(groups, lr_schedule, momentum=mom, weight_decay=wd, **chain),
        "adamw": lambda: Adam(groups, lr_schedule, weight_decay=wd, **chain),
        "adam": lambda: Adam(groups, lr_schedule, **chain),
        "sgd": lambda: SGD(groups, lr_schedule, momentum=mom, **chain),
        "lamb": lambda: zoo.Lamb(groups, lr_schedule, weight_decay=wd, **chain),
        "radam": lambda: zoo.RAdam(groups, lr_schedule, **chain),
        "adabelief": lambda: zoo.AdaBelief(groups, lr_schedule, weight_decay=wd, **chain),
        "madgrad": lambda: zoo.Madgrad(groups, lr_schedule, momentum=mom, weight_decay=wd,
                                       **chain),
        "sgd_gc": lambda: zoo.SGDGC(groups, lr_schedule, momentum=mom, weight_decay=wd,
                                    **chain),
    }
    build["ranger_adabelief"] = build["rangeradabelief"]
    name = sc.optimizer.lower()
    if name not in build:
        raise ValueError(f"unknown optimizer {sc.optimizer}")
    return build[name]()
