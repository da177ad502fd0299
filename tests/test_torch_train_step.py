"""Port parity: GDRN train steps against the JAX package.

One and seven steps of ``tests/test_model_train_step.py::tiny_cfg``
(convnext_tiny at 64 -> 16, 3 classes, fp32, Ranger with NaN-to-zero,
flat-and-anneal over 20 iterations with a 2-step warmup, EMA) from the same
params (drawn by ``torch_parity_utils``, mapped with
``utils/weights.py::state_dict_from_flax``) on the same fake batch. The JAX
side is ``make_train_step`` on ``create_train_state``; the port's is its
``make_train_step`` on ``create_train_state``.

Agreement: the loss dict, total_loss, error_R_deg and error_t_cm of each
step at 1e-5; gradients (at the initial params, and at the JAX package's
params before its seventh step, loaded into the port: the same point, so
that six steps of fp32 rounding do not enter the comparison), params,
Ranger's exp_avg / exp_avg_sq / slow and the EMA weights, mapped into the
port's names, at 1e-4 relative with 1e-4 of each tensor's largest
magnitude as the absolute floor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnpp_bop2022_tpu.engine import create_train_state as j_create_state
from gdrnpp_bop2022_tpu.engine import make_train_step as j_make_step
from gdrnpp_bop2022_tpu.geometry.symmetry import build_sym_bank as j_sym_bank
from gdrnpp_bop2022_tpu.solver import build_lr_scheduler as j_sched
from gdrnpp_bop2022_tpu.solver import build_optimizer as j_build_opt
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.engine.train_state import create_train_state
from gdrnpp_bop2022_torch.engine.train_step import (forward_outputs, loss_and_metrics,
                                                    make_eval_step, make_train_step)
from gdrnpp_bop2022_torch.geometry.symmetry import build_sym_bank
from gdrnpp_bop2022_torch.solver.lr_scheduler import build_lr_scheduler
from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
from gdrnpp_bop2022_torch.utils.weights import state_dict_from_flax
from test_model_train_step import make_batch, tiny_cfg
from torch_parity_utils import jax_gdrn_params, port_gdrn

# tiny_cfg()'s overrides, for the port's own Config
TINY = {"model.pose_net.num_classes": 3, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32",
        "solver.total_epochs": 2, "solver.warmup_iters": 2}
STEPS = 7
ITERS_PER_EPOCH = 10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on eight cores, and torch's default of one thread per core in
    each of them oversubscribes the CPU (one run took 30x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _keep_grads():
    """An identity transformation whose state is the last gradients it saw:
    chained in front of the JAX optimizer, it shows each step's gradients
    without a second compiled program."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _port_grads(model, cfg, batch, sym):
    model.zero_grad(set_to_none=True)
    total, _ = loss_and_metrics(cfg, forward_outputs(model, batch), batch, *sym)
    total.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    jcfg = tiny_cfg()
    tcfg = replace_cfg(Config(), TINY)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodel, params = jax_gdrn_params(jcfg, seed=0)
    jbatch = make_batch(jcfg)
    nb = {k: np.asarray(v) for k, v in jbatch.items()}
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
              for k, v in nb.items()}
    jsym = j_sym_bank([None] * 3)
    tsym = build_sym_bank([None] * 3)

    # JAX: STEPS train steps, keeping the first and the last step's grads
    tx = optax.chain(_keep_grads(),
                     j_build_opt(jcfg, j_sched(jcfg, iters_per_epoch=ITERS_PER_EPOCH)))
    jstate = j_create_state(jmodel.apply, jax.tree.map(jnp.asarray, params), tx)
    jstep = j_make_step(jcfg, *jsym)
    j = {"grads": [], "metrics": [], "snap": {}}
    for i in range(STEPS):
        if i == STEPS - 1:
            params_before_last = jax.device_get(jstate.params)
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(1), jnp.asarray(0.0))
        j["metrics"].append({k: float(v) for k, v in m.items()})
        if i in (0, STEPS - 1):
            j["grads"].append(jax.device_get(jstate.opt_state[0]))
        if i + 1 in (1, STEPS):
            ranger_state = jstate.opt_state[1][1]     # after NaN-to-zero's empty state
            j["snap"][i + 1] = jax.device_get({
                "params": jstate.params, "ema": jstate.ema_params,
                "exp_avg": ranger_state.exp_avg, "exp_avg_sq": ranger_state.exp_avg_sq,
                "slow": ranger_state.slow})

    # the port
    model = port_gdrn(tcfg, params)
    opt = build_optimizer(tcfg, build_lr_scheduler(tcfg, ITERS_PER_EPOCH), model)
    state = create_train_state(model, opt)
    step = make_train_step(tcfg, *tsym)
    t = {"grads": [_port_grads(model, tcfg, tbatch, tsym)], "metrics": [], "snap": {}}
    names = state.param_names()
    for i in range(STEPS):
        t["metrics"].append({k: float(v) for k, v in step(state, tbatch).items()})
        if i + 1 in (1, STEPS):
            ps = list(model.parameters())
            t["snap"][i + 1] = {
                "params": {n: p.detach().clone() for n, p in zip(names, ps)},
                "ema": {n: e.clone() for n, e in zip(names, state.ema)},
                **{k: {n: opt.state[p][k].clone() for n, p in zip(names, ps)}
                   for k in ("exp_avg", "exp_avg_sq", "slow")}}
    assert state.step == STEPS and opt.param_groups[0]["count"] == STEPS
    t["grads"].append(_port_grads(port_gdrn(tcfg, params_before_last), tcfg, tbatch, tsym))
    return jcfg, tcfg, j, t, state, tbatch


def _close_tree(tcfg, jtree, tdict, what):
    want = state_dict_from_flax(jtree, tcfg)
    assert set(want) == set(tdict), what
    for n, w in want.items():
        w = w.numpy()
        g = tdict[n].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("n", [1, STEPS])
def test_train_steps_match_jax(runs, n):
    jcfg, tcfg, j, t, _, _ = runs
    for i in range(n):
        jm, tm = j["metrics"][i], t["metrics"][i]
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    gi = 0 if n == 1 else 1
    _close_tree(tcfg, j["grads"][gi], t["grads"][gi], f"grads before step {n}")
    for what in ("params", "ema", "exp_avg", "exp_avg_sq", "slow"):
        _close_tree(tcfg, j["snap"][n][what], t["snap"][n][what], f"{what} after step {n}")


def test_params_moved_and_eval_reads_ema(runs):
    _, tcfg, j, t, state, tbatch = runs
    first = t["metrics"][0]["total_loss"]
    assert np.isfinite(first) and all(np.isfinite(m["total_loss"]) for m in t["metrics"])
    p, e = t["snap"][STEPS]["params"], t["snap"][STEPS]["ema"]
    assert any(not torch.equal(p[n], e[n]) for n in p)
    eval_ema = make_eval_step()(state, tbatch)
    eval_raw = make_eval_step(use_ema=False)(state, tbatch)
    assert state.model.training
    with torch.no_grad():
        state.model.eval()
        direct = forward_outputs(state.model, tbatch)
        state.model.train()
    torch.testing.assert_close(eval_raw["rot"], direct["rot"], rtol=0, atol=0)
    assert not torch.equal(eval_ema["rot"], eval_raw["rot"])
