"""Port parity: the optimizer zoo and gradient accumulation against the JAX
package's ``build_optimizer``.

One parametrised test runs every optimizer that ``build_optimizer`` builds
beyond Ranger, Adam, AdamW and SGD (ranger21, adamp, sgdp, lamb, radam,
adabelief, madgrad, sgd_gc) for 5 steps on a tree that covers each layout the optimizers treat
apart: a conv (torch (O, I, kh, kw), flax (kh, kw, I, O)), a ConvTranspose
of the same torch shape (torch (I, O, kh, kw), flax (kh, kw, I, O) flipped:
its output unit is dim 1), a linear weight and bias, a vector and a scalar
(``log_var_*``). Parameters after every step at 1e-5 relative, with 1e-5 of
each tensor's largest magnitude as the absolute floor.

``solver.grad_accum_steps=2`` over 4 micro-steps against the JAX chain in
``optax.MultiSteps``: the parameters move on micro-steps 2 and 4 only, to
the update of the mean gradient, at the same tolerance; and a checkpoint
taken between the two micro-steps of an update resumes bit for bit.
"""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnpp_bop2022_tpu.config import Config as JConfig, replace_cfg as jreplace
from gdrnpp_bop2022_tpu.solver.lr_scheduler import flat_and_anneal_schedule as j_sched
from gdrnpp_bop2022_tpu.solver.ranger import build_optimizer as j_build_optimizer
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.solver.lr_scheduler import flat_and_anneal_schedule
from gdrnpp_bop2022_torch.solver.ranger import build_optimizer

TOL = 1e-5
ZOO = ("ranger21", "adamp", "sgdp", "lamb", "radam", "adabelief", "madgrad", "sgd_gc")


class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        rs = np.random.RandomState(seed)
        self.conv = torch.nn.Conv2d(4, 4, 3, bias=False)
        self.deconv = torch.nn.ConvTranspose2d(4, 4, 3, bias=False)
        self.fc = torch.nn.Linear(6, 5)
        self.vec = torch.nn.Parameter(torch.zeros(7))
        self.log_var_z = torch.nn.Parameter(torch.zeros(()))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(np.asarray(rs.randn(*p.shape), np.float32)))


# port name -> (flax leaf name, torch -> flax layout)
LAYOUT = {"conv.weight": ("conv", lambda a: np.transpose(a, (2, 3, 1, 0))),
          "deconv.weight": ("deconv", lambda a: np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]),
          "fc.weight": ("fc_w", lambda a: a.T), "fc.bias": ("fc_b", lambda a: a),
          "vec": ("vec", lambda a: a), "log_var_z": ("log_var_z", lambda a: a)}


def _flax(named):
    return {LAYOUT[n][0]: jnp.asarray(np.array(LAYOUT[n][1](np.asarray(v)), copy=True))
            for n, v in named.items()}


def _check(model, jparams, what):
    for n, p in model.named_parameters():
        leaf, to_flax = LAYOUT[n]
        want = np.asarray(jparams[leaf])
        got = to_flax(p.detach().numpy())
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()),
                                   err_msg=f"{what} {n}")


def _grads(model, rs, scale):
    return {n: np.asarray(rs.randn(*p.shape) * scale, np.float32)
            for n, p in model.named_parameters()}


def _setup(over):
    jcfg, tcfg = jreplace(JConfig(), over), replace_cfg(Config(), over)
    model = _Net(0)
    opt = build_optimizer(tcfg, flat_and_anneal_schedule(1e-2, 20, warmup_iters=2), model)
    tx = j_build_optimizer(jcfg, j_sched(1e-2, 20, warmup_iters=2))
    jparams = _flax({n: p.detach() for n, p in model.named_parameters()})
    return model, opt, tx, jparams, tx.init(jparams)


def _step(model, opt, tx, jparams, jstate, grads):
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n].copy())
    stepped = opt.step()
    upd, jstate = tx.update(_flax(grads), jstate, jparams)
    return stepped, optax.apply_updates(jparams, upd), jstate


@pytest.mark.parametrize("name", ZOO)
def test_zoo_optimizer_matches_jax(name):
    model, opt, tx, jparams, jstate = _setup({"solver.optimizer": name})
    # the ConvTranspose weight is a block of its own (output unit dim 1)
    assert {opt.unit_dim(p) for p in model.parameters()} == {0, 1}
    rs = np.random.RandomState(1)
    for step in range(5):
        stepped, jparams, jstate = _step(model, opt, tx, jparams, jstate,
                                         _grads(model, rs, 1 + step % 3))
        assert stepped
        _check(model, jparams, f"{name} step {step + 1}")
    assert opt.param_groups[0]["count"] == 5
    assert any(opt.state[p] for p in model.parameters()) or name in ("sgd_gc",)


def test_grad_accum_matches_optax_multisteps():
    over = {"solver.optimizer": "ranger", "solver.grad_accum_steps": 2,
            "solver.nan_grad_to_zero": True}
    model, opt, tx, jparams, jstate = _setup(over)
    rs = np.random.RandomState(2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    saved = None
    for micro in range(4):
        grads = _grads(model, rs, 1 + micro)
        if micro == 2:              # between the two micro-steps of the second update
            buf = io.BytesIO()
            torch.save({"opt": opt.state_dict(),
                        "params": {n: p.detach().clone() for n, p in model.named_parameters()}},
                       buf)
            saved = (buf.getvalue(), grads, int(opt.param_groups[0]["mini_step"]))
        stepped, jparams, jstate = _step(model, opt, tx, jparams, jstate, grads)
        assert stepped == (micro % 2 == 1), micro
        _check(model, jparams, f"micro-step {micro + 1}")
        moved = any(not torch.equal(before[n], p) for n, p in model.named_parameters())
        assert moved == (micro >= 1), micro
        if micro == 3:
            final = {n: p.detach().clone() for n, p in model.named_parameters()}
            last_grads = grads
    assert opt.param_groups[0]["count"] == 2
    # resume from micro-step 3: the accumulator and mini_step come back
    blob, grads3, mini = saved
    assert mini == 0
    m2, o2, _, _, _ = _setup(over)
    payload = torch.load(io.BytesIO(blob), weights_only=False)
    with torch.no_grad():
        for n, p in m2.named_parameters():
            p.copy_(payload["params"][n])
    o2.load_state_dict(payload["opt"])
    for g in (grads3, last_grads):
        for n, p in m2.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        o2.step()
    for n, p in m2.named_parameters():
        assert torch.equal(p, final[n]), n
