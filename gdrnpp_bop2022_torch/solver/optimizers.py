"""The rest of the JAX package's optimizer zoo on ``ChainedOptimizer``.

Port of ``gdrnpp_bop2022_tpu/solver/optimizers.py`` (reference
lib/torch_utils/solver/, registry core/utils/solver_utils.py:28-72):
AdaBelief, MADGRAD, SGD with gradient centralization, AdamP, SGDP and
Ranger21, and of the two optax optimizers ``build_optimizer`` takes
(``optax.lamb``, ``optax.radam``), written out here. Each keeps its state
stacked per block of parameters (``solver/ranger.py``) and computes its
scalars on the host in fp32, in the JAX package's order of operations.

What the JAX package computes per output unit (AdamP / SGDP's channel
view, Ranger21's unit norms) groups a torch weight by ``unit_dim`` (dim 0,
dim 1 for ConvTranspose); what it computes per leaf is per parameter here,
over dims 1.. of a block's (n, *shape) stack.
"""

from __future__ import annotations

import torch

from .ranger import GC_DIMS, ChainedOptimizer, _bias_correction, _f32


def _f(v) -> float:
    """A host scalar rounded to fp32."""
    return float(_f32(float(v)))


def _leaf_dims(S: torch.Tensor):
    """The dims of one parameter in a block's (n, *shape) stack."""
    return tuple(range(1, S.ndim))


def _b(v: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """A per-parameter (n,) value broadcast against a stack S."""
    return v.reshape((-1,) + (1,) * (S.ndim - 1))


def _centralize(S: torch.Tensor) -> torch.Tensor:
    """Gradient centralization as the JAX package's (flax axes 1..)."""
    nd = S.ndim - 1
    if nd not in GC_DIMS:
        raise ValueError(f"no gradient-centralization layout for a {nd}-D tensor")
    return S - S.mean(dim=tuple(d + 1 for d in GC_DIMS[nd]), keepdim=True)


def _unit_rows(S: torch.Tensor, unit: int) -> torch.Tensor:
    """(n, *shape) -> (n, units, rest): one row per output unit."""
    return S.movedim(unit + 1, 1).reshape(S.shape[0], S.shape[unit + 1], -1)


def _from_unit_rows(R: torch.Tensor, S: torch.Tensor, unit: int) -> torch.Tensor:
    return R.reshape(S.movedim(unit + 1, 1).shape).movedim(1, unit + 1)


def _unit_norm(S: torch.Tensor, unit: int) -> torch.Tensor:
    """Ranger21's unit norm: the whole parameter's for 0-D and 1-D ones,
    else one per output unit; broadcastable against S."""
    if S.ndim <= 2:
        return torch.linalg.vector_norm(S, dim=_leaf_dims(S), keepdim=True)
    dims = tuple(d for d in range(1, S.ndim) if d != unit + 1)
    return torch.sqrt(torch.sum(S * S, dim=dims, keepdim=True))


class AdaBelief(ChainedOptimizer):
    """AdaBelief (Zhuang et al. 2020; reference solver/AdaBelief.py): the
    EMA of (g - m)^2 + eps instead of the raw second moment. State:
    exp_avg, exp_avg_var."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-16,
                 weight_decay: float = 0.0, **chain):
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        b1, b2 = self.betas
        m = self._state(blocks, params, "exp_avg", torch.zeros_like)
        s = self._state(blocks, params, "exp_avg_var", torch.zeros_like)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        d = torch._foreach_sub(grads, m)
        torch._foreach_mul_(s, b2)
        torch._foreach_addcmul_(s, d, d, value=1.0 - b2)
        torch._foreach_add_(s, self.eps)
        m_hat = torch._foreach_div(m, _bias_correction(b1, count))
        denom = torch._foreach_div(s, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(m_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_mul_(step, -lr)
        return step


class Madgrad(ChainedOptimizer):
    """MADGRAD (Defazio & Jelassi 2021; reference solver/madgrad.py), the
    dual-averaging form: lamb = (lr + eps) sqrt(k + 1), s += lamb g,
    v += lamb g^2, z = x0 - s / (cbrt(v) + eps), update (1 - momentum)(z - p).
    State: grad_sum, grad_sum_sq, x0 (the parameters at the first step)."""

    def __init__(self, params, schedule, momentum: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0, **chain):
        self.momentum, self.eps, self.weight_decay = momentum, eps, weight_decay
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        s = self._state(blocks, params, "grad_sum", torch.zeros_like)
        v = self._state(blocks, params, "grad_sum_sq", torch.zeros_like)
        x0 = self._state(blocks, params, "x0", torch.clone)
        lamb = float((_f32(lr) + self.eps) * torch.sqrt(_f32(float(count - 1)) + 1.0))
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        gl = torch._foreach_mul(grads, lamb)
        torch._foreach_add_(s, gl)
        torch._foreach_addcmul_(v, gl, grads)
        denom = torch._foreach_pow(v, 1.0 / 3.0)
        torch._foreach_add_(denom, self.eps)
        z = torch._foreach_sub(x0, torch._foreach_div(s, denom))
        out = torch._foreach_sub(z, params)
        torch._foreach_mul_(out, 1.0 - self.momentum)
        return out


class SGDGC(ChainedOptimizer):
    """SGD with gradient centralization (reference solver/sgd_gc.py), as the
    JAX package chains it: centralize, optax.sgd (trace = g + momentum
    trace, times -lr), then ``optax.add_decayed_weights(-weight_decay)``.
    State: momentum_buffer."""

    def __init__(self, params, schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 gc_conv_only: bool = False, **chain):
        self.momentum, self.weight_decay = momentum, weight_decay
        self.gc_min_ndim = 4 if gc_conv_only else 2
        super().__init__(params, schedule, **chain)

    def _precondition(self, stacks):
        for i, S in enumerate(stacks):
            if S.ndim - 1 >= self.gc_min_ndim:
                stacks[i] = _centralize(S)

    def _updates(self, blocks, params, grads, count, lr):
        if self.momentum:
            buf = self._state(blocks, params, "momentum_buffer", torch.zeros_like)
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, grads)
            grads = buf
        out = torch._foreach_mul(grads, -lr)
        if self.weight_decay:
            torch._foreach_add_(out, params, alpha=-self.weight_decay)
        return out


def _cosine_max(X: torch.Tensor, Y: torch.Tensor, eps: float) -> torch.Tensor:
    """(n, rows, k) views -> (n,): the largest |cos| between matching rows."""
    num = torch.abs(torch.sum(X * Y, dim=2))
    den = torch.clamp_min(torch.linalg.vector_norm(X, dim=2)
                          * torch.linalg.vector_norm(Y, dim=2), eps)
    return (num / den).amax(dim=1)


def _projected(P: torch.Tensor, U: torch.Tensor, eps: float) -> torch.Tensor:
    """U less, row by row, its component along the same row of P."""
    pn = P / (torch.linalg.vector_norm(P, dim=2, keepdim=True) + eps)
    return U - pn * torch.sum(pn * U, dim=2, keepdim=True)


def _adamp_project(P, G, U, unit: int, delta: float, wd_ratio: float, eps: float):
    """AdamP / SGDP's projection (reference adamp.py:48-62) on a block's
    stacks: where a parameter's gradient is nearly orthogonal to it, per
    output unit (else over the whole tensor), the radial part of the update
    goes and its weight decay shrinks by wd_ratio. Returns (U', wd (n,))."""
    n = P.shape[0]
    if P.ndim <= 2:                  # 0-D and 1-D parameters: no projection
        return U, torch.ones(n, dtype=torch.float32, device=P.device)
    Pc, Gc, Uc = (_unit_rows(t, unit) for t in (P, G, U))
    Pl, Gl, Ul = (t.reshape(n, 1, -1) for t in (P, G, U))
    cond_ch = _cosine_max(Gc, Pc, eps) < float(delta / torch.sqrt(_f32(Pc.shape[2])))
    cond_ly = _cosine_max(Gl, Pl, eps) < float(delta / torch.sqrt(_f32(Pl.shape[2])))
    proj_ch = _from_unit_rows(_projected(Pc, Uc, eps), P, unit)
    proj_ly = _projected(Pl, Ul, eps).reshape(P.shape)
    out = torch.where(_b(cond_ch, P), proj_ch, torch.where(_b(cond_ly, P), proj_ly, U))
    ones = torch.ones(n, dtype=torch.float32, device=P.device)
    return out, torch.where(cond_ch | cond_ly, wd_ratio * ones, ones)


class AdamP(ChainedOptimizer):
    """AdamP (reference adamp.py:13-122): Adam whose update is projected by
    ``_adamp_project``. State: exp_avg, exp_avg_sq."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = False, **chain):
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        b1, b2 = self.betas
        m = self._state(blocks, params, "exp_avg", torch.zeros_like)
        v = self._state(blocks, params, "exp_avg_sq", torch.zeros_like)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        bias1 = _bias_correction(b1, count)
        sqrt_bias2 = float(torch.sqrt(_f32(_bias_correction(b2, count))))
        out = []
        for (_, ps), P, G, M, V in zip(blocks, params, grads, m, v):
            denom = torch.sqrt(V) / sqrt_bias2 + self.eps
            U = ((b1 * M + (1 - b1) * G) if self.nesterov else M) / denom
            U, wd = _adamp_project(P, G, U, self.unit_dim(ps[0]), self.delta,
                                   self.wd_ratio, self.eps)
            step = -_f(lr / bias1) * U
            if self.weight_decay > 0:
                step = step - _b(lr * self.weight_decay * wd, P) * P
            out.append(step)
        return out


class SGDP(ChainedOptimizer):
    """SGDP (reference sgdp.py:13-116): SGD with momentum whose update is
    projected by ``_adamp_project``. State: momentum_buffer."""

    def __init__(self, params, schedule, momentum: float = 0.9, dampening: float = 0.0,
                 weight_decay: float = 0.0, delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = False, eps: float = 1e-8, **chain):
        self.momentum, self.dampening, self.weight_decay = momentum, dampening, weight_decay
        self.delta, self.wd_ratio, self.nesterov, self.eps = delta, wd_ratio, nesterov, eps
        super().__init__(params, schedule, **chain)

    def _updates(self, blocks, params, grads, count, lr):
        buf = self._state(blocks, params, "momentum_buffer", torch.zeros_like)
        torch._foreach_mul_(buf, self.momentum)
        torch._foreach_add_(buf, grads, alpha=1.0 - self.dampening)
        out = []
        for (_, ps), P, G, Bf in zip(blocks, params, grads, buf):
            d_p = G + self.momentum * Bf if self.nesterov else Bf
            d_p, wd = _adamp_project(P, G, d_p, self.unit_dim(ps[0]), self.delta,
                                     self.wd_ratio, self.eps)
            step = -lr * d_p
            if self.weight_decay > 0:
                step = step - _b(lr * self.weight_decay * wd / (1 - self.momentum), P) * P
            out.append(step)
        return out


class Lamb(ChainedOptimizer):
    """optax.lamb: Adam's direction (eps 1e-6), plus weight_decay p, scaled
    per parameter by the trust ratio ||p|| / ||u|| (1 where either is 0),
    times -lr. State: exp_avg, exp_avg_sq."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-6,
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
        u = torch._foreach_div(m_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(u, params, alpha=self.weight_decay)
        out = []
        for P, U in zip(params, u):
            pn = torch.linalg.vector_norm(P, dim=_leaf_dims(P))
            un = torch.linalg.vector_norm(U, dim=_leaf_dims(U))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            out.append(U * _b(ratio, U) * -lr)
        return out


class RAdam(ChainedOptimizer):
    """optax.radam: Adam's debiased moments, rectified by r where
    rho >= threshold, else the debiased first moment alone; times -lr.
    State: exp_avg, exp_avg_sq."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0, **chain):
        self.betas, self.eps, self.threshold = betas, eps, threshold
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
        t = _f32(float(count))
        b2t = torch.pow(_f32(b2), t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        if float(ro) >= self.threshold:
            r = float(torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                 / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
            denom = torch._foreach_div(v, _bias_correction(b2, count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(torch._foreach_mul(m_hat, r), denom)
        else:
            step = m_hat
        torch._foreach_mul_(step, -lr)
        return step


class Ranger21(ChainedOptimizer):
    """Ranger21 (reference solver/ranger21.py) with the vendored file's
    default features, as the JAX package fuses them: adaptive gradient
    clipping per output unit, gradient centralization and normalization,
    positive-negative momentum (alternating EMAs), a softplus-smoothed
    denominator, stable weight decay (over the mean of the debiased second
    moment of every parameter), norm loss, and lookahead (k 5, alpha 0.5).
    State: grad_ma, neg_grad_ma, variance_ma, slow."""

    def __init__(self, params, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4, use_gc: bool = True, use_gcnorm: bool = True,
                 agc_clip: float = 1e-2, agc_eps: float = 1e-3, pnm_factor: float = 1.0,
                 softplus_beta: float = 50.0, normloss_factor: float = 1e-4,
                 lookahead_k: int = 5, lookahead_alpha: float = 0.5, **chain):
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.use_gc, self.use_gcnorm = use_gc, use_gcnorm
        self.agc_clip, self.agc_eps, self.pnm_factor = agc_clip, agc_eps, pnm_factor
        self.softplus_beta, self.normloss_factor = softplus_beta, normloss_factor
        self.lookahead_k, self.lookahead_alpha = lookahead_k, lookahead_alpha
        super().__init__(params, schedule, **chain)

    def _precondition_block(self, P, G, unit):
        p_n = torch.clamp_min(_unit_norm(P, unit), self.agc_eps)
        g_n = _unit_norm(G, unit)
        max_n = p_n * self.agc_clip
        G = torch.where(g_n > max_n, G * (max_n / torch.clamp_min(g_n, 1e-6)), G)
        if self.use_gc and G.ndim > 2:
            G = _centralize(G)
        if self.use_gcnorm and G[0].numel() > 2:
            G = G / (_b(torch.std(G, dim=_leaf_dims(G), correction=0), G) + 1e-8)
        return G

    def _updates(self, blocks, params, grads, count, lr):
        b1, b2 = self.betas
        units = [self.unit_dim(ps[0]) for _, ps in blocks]
        grads = [self._precondition_block(P, G, u) for P, G, u in zip(params, grads, units)]
        m_pos = self._state(blocks, params, "grad_ma", torch.zeros_like)
        m_neg = self._state(blocks, params, "neg_grad_ma", torch.zeros_like)
        v = self._state(blocks, params, "variance_ma", torch.zeros_like)
        slow = self._state(blocks, params, "slow", torch.clone)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        bc1 = _bias_correction(b1, count)
        bc2 = _bias_correction(b2, count)
        n_param = sum(V.numel() for V in v)
        v_sum = torch.stack([V.sum() for V in v]).sum() / bc2
        var_norm = torch.clamp_min(torch.sqrt(v_sum / n_param), self.eps)
        odd = count % 2 == 1
        active, other = (m_pos, m_neg) if odd else (m_neg, m_pos)
        torch._foreach_mul_(active, b1 * b1)
        torch._foreach_add_(active, grads, alpha=1 - b1 * b1)
        noise_norm = float(torch.sqrt(_f32((1.0 + b2) ** 2 + b2 ** 2)))
        sqrt_bc2 = float(torch.sqrt(_f32(bc2)))
        beta = self.softplus_beta
        sync = count % self.lookahead_k == 0
        out = []
        for P, V, A, O, S, u in zip(params, v, active, other, slow, units):
            denom = torch.sqrt(V) / sqrt_bc2 + self.eps
            denom = torch.logaddexp(denom * beta, torch.zeros_like(denom)) / beta
            pnm = ((1.0 + self.pnm_factor) * A - self.pnm_factor * O) / noise_norm
            new_p = P
            if self.weight_decay > 0:
                new_p = new_p * torch.clamp(1.0 - self.weight_decay * lr / var_norm, 0.0, 1.0)
            if self.normloss_factor > 0:
                corr = 2.0 * self.normloss_factor * (1.0 - 1.0 / (_unit_norm(P, u) + self.eps))
                new_p = new_p * torch.clamp(1.0 - lr * corr, 0.0, 2.0)
            new_p = new_p - _f(lr / bc1) * pnm / denom
            if sync:                 # lookahead: slow += alpha (fast - slow)
                S.add_(new_p - S, alpha=self.lookahead_alpha)
                new_p = S
            out.append(new_p - P)
        return out
