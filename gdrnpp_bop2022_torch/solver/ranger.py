"""Optimizers of the GDRN recipe: Ranger (RAdam + Lookahead + gradient
centralization), RangerAdaBelief, Adam, AdamW and SGD, as one
``torch.optim.Optimizer`` family that updates whole parameter lists with
``torch._foreach_*`` ops.

Port of ``gdrnpp_bop2022_tpu/solver/ranger.py`` (``ranger``,
``build_optimizer``, ``scale_updates_by_module``; reference
lib/torch_utils/solver/ranger.py) and of the optax transformations it
chains. One ``step()`` applies, in the JAX package's order:

  1. NaN/inf gradients to 0 (``solver.nan_grad_to_zero``), as
     ``where(isfinite(g), g, 0)``;
  2. clipping by the global norm (``solver.clip_grad_norm`` > 0): scaled by
     max_norm / norm only when norm > max_norm (optax.clip_by_global_norm);
  3. the optimizer's update, with the learning rate of ``schedule(count - 1)``
     (the first update uses step 0's rate, as optax does);
  4. the update times its parameter group's ``lr_mult`` (geo head, PnP net),
     then added to the parameters.

Parameters are taken in blocks of one group and one (shape, dtype, device):
ConvNeXt-base GDRN's 380 parameters make 33 blocks. Each step stacks a
block's gradients and parameters into one (n, *shape) tensor, and the
optimizer state lives stacked the same way (``state[p][name]`` is a view
into it), so every pass of the chain and of the update is one op per block,
or one ``_foreach_`` op over the blocks, rather than one per parameter. Only
the last pass, adding the updates to the parameters, is a ``_foreach_`` op
over every parameter.

The step count and the learning rate live on the host; the RAdam and bias
correction scalars are computed from them in fp32 in the JAX package's order
of operations (RAdam's n_sma cancels in fp32: 0.974 at step 1, not 1.0), so
nothing in a step waits on the device.

Gradient centralization follows the JAX package, which centralizes over
axes 1.. of the flax layout. Mapped onto torch layouts that is: 4-D conv
(O, I, kh, kw) and ConvTranspose (I, O, kh, kw) weights over every dim but
2; 2-D linear (O, I) weights over dim 0; 1-D tensors not at all. (The
reference's torch Ranger keeps dim 0 of the torch layout instead.)
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
                 clip_grad_norm: float = 0.0):
        if callable(schedule):
            self.schedule = schedule
        else:
            rate = float(schedule)
            self.schedule = lambda step: rate
        self.nan_grad_to_zero = nan_grad_to_zero
        self.clip_grad_norm = clip_grad_norm
        self._layout = (None, [])    # (parameter ids, blocks)
        self._stacked = {}           # (state name, block index) -> (n, *shape) tensor
        super().__init__(params, {"lr_mult": 1.0, "count": 0})

    def _blocks(self):
        """[(group, [params])], one entry per (group, shape, dtype, device),
        in parameter order; recomputed when the parameters change."""
        key = tuple(id(p) for g in self.param_groups for p in g["params"])
        if self._layout[0] != key:
            blocks = []
            for group in self.param_groups:
                by_shape = {}
                for p in group["params"]:
                    by_shape.setdefault((p.shape, p.dtype, p.device), []).append(p)
                blocks += [(group, ps) for ps in by_shape.values()]
            self._layout = (key, blocks)
            self._stacked = {}
        return self._layout[1]

    def _grads(self, blocks):
        """The chain's gradients, stacked per block: NaN-to-zero'd, clipped
        and ``_precondition``-ed. ``p.grad`` itself is left as it is."""
        stacks = []
        for _, ps in blocks:
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            s = torch.stack([p.grad for p in ps])
            if self.nan_grad_to_zero:
                s = torch.where(torch.isfinite(s), s, 0.0)
            stacks.append(s)
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

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        blocks = self._blocks()
        if not blocks:
            return
        grads = self._grads(blocks)
        params = [torch.stack(ps) for _, ps in blocks]
        count = self.param_groups[0]["count"] + 1
        updates = self._updates(blocks, params, grads, count, self.schedule(count - 1))
        for (group, _), u in zip(blocks, updates):
            if group["lr_mult"] != 1.0:
                u.mul_(group["lr_mult"])
        for group in self.param_groups:
            group["count"] = count
        torch._foreach_add_([p for _, ps in blocks for p in ps],
                            [v for u in updates for v in u.unbind(0)])


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
    """optax.sgd: with momentum, trace = g + momentum * trace. State:
    momentum_buffer."""

    def __init__(self, params, schedule, momentum: float = 0.0, **chain):
        self.momentum = momentum
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        if self.momentum:
            buf = self._state(blocks, params, "momentum_buffer", torch.zeros_like)
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, grads)
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


def build_optimizer(cfg, lr_schedule, model: torch.nn.Module) -> ChainedOptimizer:
    """The optimizer of ``cfg.solver`` for ``model`` (reference
    core/utils/solver_utils.py:28-110): ranger | ranger_adabelief | adam |
    adamw | sgd, chained with NaN-to-zero, clipping and the geo head's and
    PnP net's lr_mult. The other optimizers of the JAX package's zoo and
    gradient accumulation arrive with slice 3b."""
    sc = cfg.solver
    if sc.grad_accum_steps > 1:
        raise NotImplementedError("solver.grad_accum_steps > 1 arrives with slice 3b")
    pc = cfg.model.pose_net
    lr_mults = {}
    if pc.geo_head.lr_mult != 1.0:
        lr_mults["geo_head_net."] = pc.geo_head.lr_mult
    if pc.pnp_net.lr_mult != 1.0:
        lr_mults["pnp_net."] = pc.pnp_net.lr_mult
    groups = param_groups(model, lr_mults)
    chain = dict(nan_grad_to_zero=sc.nan_grad_to_zero, clip_grad_norm=sc.clip_grad_norm)
    name = sc.optimizer.lower()
    if name == "ranger":
        return Ranger(groups, lr_schedule, weight_decay=sc.weight_decay, **chain)
    if name in ("rangeradabelief", "ranger_adabelief"):
        return Ranger(groups, lr_schedule, weight_decay=sc.weight_decay, belief=True, **chain)
    if name == "adamw":
        return Adam(groups, lr_schedule, weight_decay=sc.weight_decay, **chain)
    if name == "adam":
        return Adam(groups, lr_schedule, **chain)
    if name == "sgd":
        return SGD(groups, lr_schedule, momentum=sc.momentum, **chain)
    raise NotImplementedError(f"optimizer {sc.optimizer!r} arrives with slice 3b "
                              "(ranger, ranger_adabelief, adam, adamw, sgd are ported)")
