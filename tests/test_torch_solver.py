"""Port parity: learning-rate schedules and optimizers against the JAX package.

  * ``flat_and_anneal_schedule`` for every warmup / anneal pair, over the
    whole run, at 1e-6 relative (plus 1e-7 x base_lr where ``1 + cos``
    cancels at the end of the anneal and one fp32 ulp of cos is most of the
    value);
  * Ranger and RangerAdaBelief over 14 steps, which cross RAdam's switch at
    n_sma > 5 (step 6) and two lookahead syncs (k = 6), with weight decay,
    on 1-D, 2-D (a linear layer, torch (O, I) = flax (I, O)^T) and 4-D (a
    conv, torch (O, I, kh, kw) = flax (kh, kw, I, O) permuted) tensors:
    parameters and exp_avg / exp_avg_sq / slow mapped to the flax layout;
  * Ranger over parameters that share shapes (they share a stacked block
    of state), its state saved with ``torch.save`` after 7 steps, one
    throwaway step taken, the saved state and parameters loaded back, and
    7 more steps, against 14 JAX steps;
  * Adam, AdamW, SGD with momentum, and SGD with Nesterov momentum after
    weight decay masked to tensors of more than one dim (the YOLOX branch),
    against optax;
  * ``build_optimizer``'s chain against the JAX one on a three-module tree
    (backbone / geo head / PnP net): NaN and inf gradients to 0, clipping by
    the global norm, and the geo head's and PnP net's lr_mult;
all at 1e-6 relative, with 1e-6 of each tensor's largest magnitude as the
absolute floor (gradient centralization subtracts a mean summed in another
order, so an element that nearly cancels differs by a few fp32 ulps of its
neighbours).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnpp_bop2022_tpu.config import Config as JConfig, replace_cfg as jreplace
from gdrnpp_bop2022_tpu.solver.lr_scheduler import flat_and_anneal_schedule as j_sched
from gdrnpp_bop2022_tpu.solver.ranger import build_optimizer as j_build_optimizer
from gdrnpp_bop2022_tpu.solver.ranger import ranger as j_ranger
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.solver.lr_scheduler import (build_lr_scheduler,
                                                      flat_and_anneal_schedule)
from gdrnpp_bop2022_torch.solver.ranger import (SGD, Adam, Ranger, build_optimizer,
                                                radam_scalars)

RTOL = 1e-6
WARMUPS = ("linear", "pow", "exp", "constant")
ANNEALS = ("cosine", "linear", "poly", "exp", "none")


@pytest.mark.parametrize("warmup", WARMUPS)
@pytest.mark.parametrize("anneal", ANNEALS)
def test_flat_and_anneal_matches_jax(warmup, anneal):
    kw = dict(base_lr=8e-4, total_iters=400, warmup_iters=37, warmup_factor=0.001,
              warmup_method=warmup, anneal_point=0.72, anneal_method=anneal,
              target_lr_factor=0.01 if anneal == "exp" else 0.0, poly_power=0.9)
    js, ts = j_sched(**kw), flat_and_anneal_schedule(**kw)
    steps = np.arange(0, 405)
    want = np.asarray(jax.vmap(js)(jnp.asarray(steps)))
    got = np.array([ts(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7 * kw["base_lr"])
    assert all(isinstance(ts(s), float) for s in (0, 100, 399))


def test_build_lr_scheduler_matches_jax():
    over = {"solver.total_epochs": 3, "solver.warmup_iters": 10}
    t = build_lr_scheduler(replace_cfg(Config(), over), 50)
    from gdrnpp_bop2022_tpu.solver.lr_scheduler import build_lr_scheduler as jb
    j = jb(jreplace(JConfig(), over), 50)
    for s in (0, 5, 10, 100, 120, 149):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=RTOL)
    const = build_lr_scheduler(replace_cfg(Config(), {"solver.lr_scheduler": "constant"}), 5)
    assert const(17) == np.float32(8e-4)


def _to_flax(t: np.ndarray) -> np.ndarray:
    if t.ndim == 4:                       # (O, I, kh, kw) -> (kh, kw, I, O)
        return np.transpose(t, (2, 3, 1, 0))
    if t.ndim == 2:                       # (O, I) -> (I, O)
        return t.T
    return t


def _tensors(rs):
    return {"bias": rs.randn(7).astype(np.float32),
            "linear": rs.randn(5, 6).astype(np.float32),
            "conv": rs.randn(4, 3, 3, 2).astype(np.float32)}


def _run(port_opt_fn, jax_tx, steps, seed=0):
    """The same params and per-step grads through both; returns (port
    params, port optimizer, jax params, jax state)."""
    rs = np.random.RandomState(seed)
    init = _tensors(rs)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = port_opt_fn(list(tparams.values()))
    jparams = {k: jnp.asarray(_to_flax(v)) for k, v in init.items()}
    jstate = jax_tx.init(jparams)
    for step in range(steps):
        grads = {k: (rs.randn(*v.shape) * (1 + step % 3)).astype(np.float32)
                 for k, v in init.items()}
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        upd, jstate = jax_tx.update({k: jnp.asarray(_to_flax(g)) for k, g in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    return tparams, opt, jparams, jstate


def _close(got: torch.Tensor, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(_to_flax(got.detach().numpy()), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("belief", [False, True])
def test_ranger_matches_jax(belief):
    sched = flat_and_anneal_schedule(1e-2, 40, warmup_iters=3, warmup_factor=0.1)
    jsched = j_sched(1e-2, 40, warmup_iters=3, warmup_factor=0.1)
    tparams, opt, jparams, jstate = _run(
        lambda ps: Ranger(ps, sched, weight_decay=0.01, belief=belief),
        j_ranger(jsched, weight_decay=0.01, belief=belief), steps=14)
    # the RAdam switch was crossed: steps 1-5 without the variance term
    assert [radam_scalars(c, 0.95, 0.999)[0] for c in range(1, 15)] == [False] * 5 + [True] * 9
    assert opt.param_groups[0]["count"] == int(jstate.count) == 14
    for k, p in tparams.items():
        _close(p, jparams[k], k)
        st = opt.state[p]
        _close(st["exp_avg"], jstate.exp_avg[k], f"{k} exp_avg")
        _close(st["exp_avg_sq"], jstate.exp_avg_sq[k], f"{k} exp_avg_sq")
        _close(st["slow"], jstate.slow[k], f"{k} slow")


def test_ranger_blocks_and_reloaded_state_match_jax():
    rs = np.random.RandomState(4)
    shapes = {"conv_a": (4, 3, 3, 2), "lin_a": (5, 6), "bias_a": (7,),
              "conv_b": (4, 3, 3, 2), "lin_b": (5, 6), "bias_b": (7,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(14)]
    sched = flat_and_anneal_schedule(1e-2, 40, warmup_iters=3, warmup_factor=0.1)
    tx = j_ranger(j_sched(1e-2, 40, warmup_iters=3, warmup_factor=0.1), weight_decay=0.01)
    jparams = {k: jnp.asarray(_to_flax(v)) for k, v in init.items()}
    jstate = tx.init(jparams)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(_to_flax(v)) for k, v in g.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Ranger(list(tparams.values()), sched, weight_decay=0.01)
    for i, g in enumerate(grads):
        if i == 7:      # save, take a throwaway step, load the saved state back
            buf = io.BytesIO()
            torch.save({"opt": opt.state_dict(),
                        "params": {k: p.detach().clone() for k, p in tparams.items()}}, buf)
            for p in tparams.values():
                p.grad = torch.ones_like(p)
            opt.step()
            buf.seek(0)
            saved = torch.load(buf, weights_only=False)
            opt.load_state_dict(saved["opt"])
            with torch.no_grad():
                for k, p in tparams.items():
                    p.copy_(saved["params"][k])
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert len(opt._blocks()) == 3
    st = opt.state
    assert (st[tparams["conv_a"]]["exp_avg"].untyped_storage().data_ptr()
            == st[tparams["conv_b"]]["exp_avg"].untyped_storage().data_ptr())
    for k, p in tparams.items():
        _close(p, jparams[k], k)
        _close(st[p]["exp_avg"], jstate.exp_avg[k], f"{k} exp_avg")
        _close(st[p]["exp_avg_sq"], jstate.exp_avg_sq[k], f"{k} exp_avg_sq")
        _close(st[p]["slow"], jstate.slow[k], f"{k} slow")


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "sgd_nesterov_wd"])
def test_adam_adamw_sgd_match_optax(name):
    """sgd_nesterov_wd: the YOLOX SGD branch, coupled weight decay on the
    tensors of more than one dim (the bias is left out) then Nesterov."""
    lr = 3e-3
    ndim_mask = lambda p: jax.tree.map(lambda x: x.ndim > 1, p)     # noqa: E731
    port, tx = {
        "adam": (lambda ps: Adam(ps, lr), optax.adam(lr)),
        "adamw": (lambda ps: Adam(ps, lr, weight_decay=0.05), optax.adamw(lr, weight_decay=0.05)),
        "sgd": (lambda ps: SGD(ps, lr, momentum=0.9), optax.sgd(lr, momentum=0.9)),
        "sgd_nesterov_wd": (
            lambda ps: SGD(ps, lr, momentum=0.9, nesterov=True, weight_decay=0.05),
            optax.chain(optax.add_decayed_weights(0.05, mask=ndim_mask),
                        optax.sgd(lr, momentum=0.9, nesterov=True))),
    }[name]
    tparams, opt, jparams, _ = _run(port, tx, steps=8, seed=1)
    for k, p in tparams.items():
        _close(p, jparams[k], k)


class _Tiny(torch.nn.Module):
    """Three top-level modules named as the port's GDRN names them."""

    def __init__(self, init):
        super().__init__()
        self.backbone = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(
            init["backbone"].copy()))})
        self.geo_head_net = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(
            init["geo_head"].copy()))})
        self.pnp_net = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(
            init["pnp_net"].copy()))})


@pytest.mark.parametrize("opt_name", ["ranger", "adam"])
def test_chain_nan_clip_lr_mult_match_jax(opt_name):
    over = {"solver.optimizer": opt_name, "solver.nan_grad_to_zero": True,
            "solver.clip_grad_norm": 2.0, "solver.weight_decay": 0.01,
            "model.pose_net.geo_head.lr_mult": 0.5, "model.pose_net.pnp_net.lr_mult": 2.0}
    jcfg, tcfg = jreplace(JConfig(), over), replace_cfg(Config(), over)
    rs = np.random.RandomState(3)
    init = {"backbone": rs.randn(6, 5).astype(np.float32),
            "geo_head": rs.randn(3, 4, 2, 2).astype(np.float32),
            "pnp_net": rs.randn(9).astype(np.float32)}
    flax_of = {"backbone": lambda a: a.T, "geo_head": lambda a: np.transpose(a, (2, 3, 1, 0)),
               "pnp_net": lambda a: a}
    model = _Tiny(init)
    sched = flat_and_anneal_schedule(1e-2, 20, warmup_iters=2)
    opt = build_optimizer(tcfg, sched, model)
    assert sorted(g["lr_mult"] for g in opt.param_groups) == [0.5, 1.0, 2.0]
    tx = j_build_optimizer(jcfg, j_sched(1e-2, 20, warmup_iters=2))
    jparams = {k: jnp.asarray(flax_of[k](v)) for k, v in init.items()}
    jstate = tx.init(jparams)
    mods = {"backbone": model.backbone, "geo_head": model.geo_head_net, "pnp_net": model.pnp_net}
    for step in range(8):
        grads = {k: (rs.randn(*v.shape) * 3).astype(np.float32) for k, v in init.items()}
        if step in (2, 5):
            grads["backbone"][1, 2] = np.nan
            grads["geo_head"][0, 1, 0, 1] = np.inf
            grads["pnp_net"][4] = -np.inf
        for k, m in mods.items():
            m["w"].grad = torch.from_numpy(grads[k].copy())
        opt.step()
        upd, jstate = tx.update({k: jnp.asarray(flax_of[k](g)) for k, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for k, m in mods.items():
        got = flax_of[k](m["w"].detach().numpy())
        assert np.isfinite(got).all()
        want = np.asarray(jparams[k])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
                                   err_msg=k)


def test_build_optimizer_refuses_what_waits():
    """Every optimizer of the JAX package's zoo builds, as does gradient
    accumulation (their parity: tests/test_torch_solver_zoo.py); a name the
    JAX package does not know raises, as there."""
    model = _Tiny({"backbone": np.zeros((2, 2), np.float32),
                   "geo_head": np.zeros((1, 1, 1, 1), np.float32),
                   "pnp_net": np.zeros(2, np.float32)})
    opt = build_optimizer(replace_cfg(Config(), {"solver.optimizer": "madgrad"}), 1e-3, model)
    assert type(opt).__name__ == "Madgrad"
    opt = build_optimizer(replace_cfg(Config(), {"solver.grad_accum_steps": 2}), 1e-3, model)
    assert isinstance(opt, Ranger) and opt.accum_steps == 2
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(replace_cfg(Config(), {"solver.optimizer": "nope"}), 1e-3, model)
