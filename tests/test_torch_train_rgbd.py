"""Port parity: RGB-D GDRN train steps against the JAX package.

One and three steps of the dual-stream model (``gdrn_dstream_double_mask``,
concat fusion: a second ConvNeXt over the backprojected depth ROI) at
``tests/test_model_train_step.py::tiny_cfg`` sizes (convnext_tiny at 64 ->
16, 3 classes, fp32, Ranger, flat-and-anneal, EMA), from the same params
(the depth backbone mapped by ``state_dict_from_flax`` as the RGB one) on
the same fake batch with a random depth ROI. The JAX side is
``make_train_step`` on ``create_train_state``, the port's its own.

Agreement, as ``tests/test_torch_train_step.py`` holds RGB: the loss dict,
total_loss, error_R_deg and error_t_cm of each step at 1e-5; gradients (at
the initial params, and at the JAX params before its last step loaded into
the port), params and EMA weights at 1e-4 relative with 1e-4 of each
tensor's largest magnitude as the absolute floor. Both backbones' weights
and gradients are among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.config import replace_cfg as jreplace
from gdrnpp_bop2022_tpu.engine import create_train_state as j_create_state
from gdrnpp_bop2022_tpu.engine import make_train_step as j_make_step
from gdrnpp_bop2022_tpu.geometry.symmetry import build_sym_bank as j_sym_bank
from gdrnpp_bop2022_tpu.solver import build_lr_scheduler as j_sched
from gdrnpp_bop2022_tpu.solver import build_optimizer as j_build_opt
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.engine.train_state import create_train_state
from gdrnpp_bop2022_torch.engine.train_step import forward_outputs, loss_and_metrics, \
    make_train_step
from gdrnpp_bop2022_torch.geometry.symmetry import build_sym_bank
from gdrnpp_bop2022_torch.solver.lr_scheduler import build_lr_scheduler
from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
from gdrnpp_bop2022_torch.utils.weights import state_dict_from_flax
from test_model_train_step import make_batch, tiny_cfg
from test_torch_train_step import TINY
from torch_parity_utils import jax_gdrn_params, port_gdrn

DSTREAM = {"model.pose_net.name": "gdrn_dstream_double_mask",
           "model.pose_net.fuse_type": "cat", "input.with_depth": True}
STEPS = 3
ITERS_PER_EPOCH = 10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_grads(model, cfg, batch, sym):
    model.zero_grad(set_to_none=True)
    total, _ = loss_and_metrics(cfg, forward_outputs(model, batch), batch, *sym)
    total.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    jcfg = jreplace(tiny_cfg(), DSTREAM)
    tcfg = replace_cfg(Config(), dict(TINY, **DSTREAM))
    jmodel, params = jax_gdrn_params(jcfg, seed=1)
    assert "depth_backbone" in params
    jbatch = dict(make_batch(jcfg))
    R = jcfg.model.pose_net.input_res
    depth = np.random.RandomState(5).randn(2, R, R, 3).astype(np.float32) * 0.3
    jbatch["roi_depth"] = jnp.asarray(depth)
    nb = {k: np.asarray(v) for k, v in jbatch.items()}
    tbatch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
              for k, v in nb.items()}
    jsym, tsym = j_sym_bank([None] * 3), build_sym_bank([None] * 3)

    import optax
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))
    tx = optax.chain(keep, j_build_opt(jcfg, j_sched(jcfg, iters_per_epoch=ITERS_PER_EPOCH)))
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
            j["snap"][i + 1] = jax.device_get({"params": jstate.params,
                                               "ema": jstate.ema_params})

    model = port_gdrn(tcfg, params)
    assert model.depth_backbone is not None
    opt = build_optimizer(tcfg, build_lr_scheduler(tcfg, ITERS_PER_EPOCH), model)
    state = create_train_state(model, opt)
    step = make_train_step(tcfg, *tsym)
    t = {"grads": [_port_grads(model, tcfg, tbatch, tsym)], "metrics": [], "snap": {}}
    names = state.param_names()
    for i in range(STEPS):
        t["metrics"].append({k: float(v) for k, v in step(state, tbatch).items()})
        if i + 1 in (1, STEPS):
            t["snap"][i + 1] = {
                "params": {n: p.detach().clone() for n, p in zip(names, model.parameters())},
                "ema": {n: e.clone() for n, e in zip(names, state.ema)}}
    t["grads"].append(_port_grads(port_gdrn(tcfg, params_before_last), tcfg, tbatch, tsym))
    return tcfg, j, t


def _close_tree(tcfg, jtree, tdict, what):
    want = state_dict_from_flax(jtree, tcfg)
    assert set(want) == set(tdict), what
    assert any(n.startswith("depth_backbone.") for n in want)
    for n, w in want.items():
        w = w.numpy()
        g = tdict[n].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("n", [1, STEPS])
def test_rgbd_train_steps_match_jax(runs, n):
    tcfg, j, t = runs
    for i in range(n):
        jm, tm = j["metrics"][i], t["metrics"][i]
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
    gi = 0 if n == 1 else 1
    _close_tree(tcfg, j["grads"][gi], t["grads"][gi], f"grads before step {n}")
    # the depth stream trains: its gradients are not zero
    assert any(float(v.abs().max()) > 0 for k, v in t["grads"][gi].items()
               if k.startswith("depth_backbone."))
    for what in ("params", "ema"):
        _close_tree(tcfg, j["snap"][n][what], t["snap"][n][what], f"{what} after step {n}")
