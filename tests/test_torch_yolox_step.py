"""Port parity: the YOLOX train step against ``make_yolox_train_step`` on the CPU.

A BN YOLOX (dep 0.33, wid 0.125, 3 classes, fp32) on 2 images of 128 x 128
with padded GTs: three steps of the JAX package's ``make_yolox_train_step``
(BatchNorm statistics threaded through, the optimizer chain of its
``train_yolox``: clip_by_global_norm(35) then Ranger on the warmup-cosine
schedule, the EMA at 0.9998) against the port's step with the weights bridged
by ``utils/weights.py::yolox_state_dict_from_flax``. After the first and the
third step: every loss within 1e-4 relative (``tests/test_torch_yolox.py``
holds the whole fp32 model's outputs to 1e-4 of each level's largest; the
loss on identical outputs agrees to 1e-5, ``test_torch_yolox_train.py``);
the parameters, the EMA and the BN running statistics within 1e-4 of each
tensor's largest magnitude; the step's gradients (recorded by an identity
transformation at the head of the JAX chain) within 1e-3 of it. The
backward through ~100 BatchNorms in training mode at this width amplifies
summation-order differences: each subtracts the incoming gradient's mean
and its projection on the normalised input, which nearly cancel (measured
on this model: 7e-4 at step 1; the same gradients with BN in eval mode
agree to 6e-6, GN at yolox_s widths to 6e-5, and one BN layer in training
mode to 1e-5, ``test_torch_yolox_train.py::test_bn_training_matches_flax``).
The parameters include the Focus stem's, whose input channels the bridge
permutes (gradient centralization must keep the flax layout's axis there
too).

Three steps of a GN YOLOX at yolox_s widths (wid 0.5) with ``use_l1=True``
(the no-aug phase) and the JAX ``train_yolox``'s SGD chain (coupled weight
decay 5e-4 masked to ndim > 1, SGD with Nesterov momentum 0.9) are checked
alike, with the gradients too within 1e-4. Both JAX steps compile once, in
two threads. The SGD branch is also held on a Focus-stem-shaped BaseConv
and a prediction conv against the JAX ``train_yolox``'s optax chain, given
the same gradients over 4 steps (one clipped).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdrnpp_bop2022_tpu.engine import yolox_trainer as jtrainer
from gdrnpp_bop2022_tpu.engine.train_state import create_train_state as j_create
from gdrnpp_bop2022_tpu.solver.ranger import ranger as j_ranger
from gdrnpp_bop2022_torch.engine import yolox_trainer as ttrainer
from gdrnpp_bop2022_torch.engine.train_state import create_train_state
from gdrnpp_bop2022_torch.utils.weights import yolox_state_dict_from_flax
from torch_parity_utils import jax_yolox, port_yolox, yolox_images

S, B, G, NC = 128, 2, 8, 3
BASE_LR, TOTAL, WARMUP = 0.002, 20, 5       # the steps stay in the (bit-exact) warmup
LOSS_TOL = 1e-4         # the whole model's forward agrees to 1e-4 of each level's largest
TENSOR_TOL = 1e-4
GRAD_TOL = 1e-3         # BN's backward in training mode; see the docstring


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _record_grads():
    """Identity on the updates; keeps the last ones in its state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


def _batches(n):
    rs = np.random.RandomState(8)
    out = []
    for i in range(n):
        boxes = np.zeros((B, G, 4), np.float32)
        boxes[..., :2] = rs.uniform(20, 108, (B, G, 2))
        boxes[..., 2:] = rs.uniform(12, 60, (B, G, 2))
        out.append({"images": yolox_images(S, seed=20 + i, n=B),
                    "gt_boxes": boxes,
                    "gt_labels": rs.randint(0, NC, (B, G)).astype(np.int32),
                    "gt_valid": np.arange(G)[None, :] < np.array([[6], [3]])})
    return out


def _params_only(sd, model):
    names = dict(model.named_parameters())
    return {k: v for k, v in sd.items() if k in names}


def _close(got: dict, want: dict, what: str, tol=TENSOR_TOL):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=tol * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=f"{what} {k}")


def _jax_sgd(sched, wd):
    """The JAX train_yolox's SGD branch: coupled decay masked to ndim > 1,
    then SGD with Nesterov momentum 0.9."""
    mask = lambda p: jax.tree.map(lambda x: x.ndim > 1, p)         # noqa: E731
    return optax.chain(optax.add_decayed_weights(wd, mask=mask),
                       optax.sgd(sched, momentum=0.9, nesterov=True))


# the two whole-step cases: (norm, wid, optimizer, use_l1, weight decay,
# gradient tolerance); GN at yolox_s widths (GN at tiny widths is
# ill-conditioned, tests/test_torch_yolox.py), where the gradients hold to 1e-4
CASES = {"bn_ranger": ("BN", 0.125, "ranger", False, 0.0, GRAD_TOL),
         "gn_sgd_l1": ("GN", 0.5, "sgd", True, 5e-4, TENSOR_TOL)}


@pytest.fixture(scope="module")
def jax_steps():
    """Each case's JAX model, TrainState and ``make_yolox_train_step``
    compiled for the batch's shapes. The two compiles (~35 s and ~20 s on
    the CPU) run in two threads: XLA releases the GIL while it compiles."""
    batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}
    cases = {}
    for name, (norm, wid, optimizer, use_l1, wd, _) in CASES.items():
        jm, params, stats = jax_yolox(norm, False, wid, S, seed=5, nc=NC)
        jsched = jtrainer.yolox_warmcos_schedule(BASE_LR, TOTAL, WARMUP)
        opt = (j_ranger(jsched, weight_decay=wd) if optimizer == "ranger"
               else _jax_sgd(jsched, wd))
        tx = optax.chain(_record_grads(), optax.clip_by_global_norm(35.0), opt)
        jstate = j_create(jm.apply, params, tx, ema_decay=0.9998, batch_stats=stats)
        jstep = jtrainer.make_yolox_train_step(jm, use_l1=use_l1, with_batch_stats=norm == "BN")
        cases[name] = [jstep, jstate, yolox_state_dict_from_flax(params, stats)]
    with ThreadPoolExecutor(len(cases)) as ex:
        compiled = {name: ex.submit(lambda c: c[0].lower(c[1], batch, jax.random.PRNGKey(1))
                                    .compile(), c) for name, c in cases.items()}
        for name, fut in compiled.items():
            cases[name][0] = fut.result()
    return cases


def run_three_steps(jax_steps, case):
    """Three steps of a case's YOLOX (dep 0.33) through the JAX
    make_yolox_train_step and the port's, checked after steps 1 and 3."""
    norm, wid, optimizer, use_l1, wd, grad_tol = CASES[case]
    jstep, jstate, sd0 = jax_steps[case]
    model = port_yolox(norm, False, wid, sd0, nc=NC)
    sched = ttrainer.yolox_warmcos_schedule(BASE_LR, TOTAL, WARMUP)
    state = create_train_state(model, ttrainer.build_yolox_optimizer(model, sched, optimizer, wd),
                               ema_decay=0.9998)
    tstep = ttrainer.make_yolox_train_step(model.strides, use_l1=use_l1)
    stem0 = model.backbone.backbone.stem.conv.conv.weight.detach().clone()

    for i, batch in enumerate(_batches(3), start=1):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(i))
        tm_ = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        if i not in (1, 3):
            continue
        assert set(tm_) == set(jm_) and ("loss_l1" in jm_) == use_l1
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=LOSS_TOL,
                                       err_msg=f"step {i} {k}")
        assert float(jm_["num_fg_per_img"]) > 0
        jstats = jax.device_get(jstate.batch_stats)
        want = yolox_state_dict_from_flax(jax.device_get(jstate.params), jstats)
        sd = model.state_dict()
        _close({k: sd[k] for k in want if "running" in k},
               {k: v for k, v in want.items() if "running" in k}, f"step {i} BN statistics")
        _close({k: p.grad for k, p in model.named_parameters()},
               _params_only(yolox_state_dict_from_flax(
                   jax.device_get(jstate.opt_state[0]["g"]), jstats), model),
               f"step {i} grads", tol=grad_tol)
        _close(dict(model.named_parameters()), _params_only(want, model), f"step {i} params")
        _close(state.ema_state_dict(),
               _params_only(yolox_state_dict_from_flax(jax.device_get(jstate.ema_params),
                                                       jstats), model), f"step {i} EMA")
    assert state.step == int(jstate.step) == 3
    assert not torch.equal(model.backbone.backbone.stem.conv.conv.weight, stem0)


def test_three_steps_match_jax(jax_steps):
    """BN at wid 0.125, Ranger, without L1 (the recipe's main phase)."""
    run_three_steps(jax_steps, "bn_ranger")


def test_three_gn_sgd_l1_steps_match_jax(jax_steps):
    """GN at yolox_s widths, SGD with coupled weight decay 5e-4 and
    Nesterov, with L1 (the no-aug phase): the gradients too within 1e-4."""
    run_three_steps(jax_steps, "gn_sgd_l1")


def test_sgd_branch_matches_jax_chain():
    """build_yolox_optimizer("sgd", wd) against the JAX train_yolox's chain:
    clip, add_decayed_weights masked to ndim > 1, sgd(momentum 0.9,
    nesterov), over 4 steps of drawn gradients (step 2 clipped), on a
    BN BaseConv of the Focus stem's shape and a prediction conv with bias."""
    from gdrnpp_bop2022_torch.models.yolox.darknet import BaseConv
    wd = 0.05
    rs = np.random.RandomState(9)
    model = torch.nn.Sequential(BaseConv(12, 8, 3, norm="BN", dtype=torch.float32),
                                torch.nn.Conv2d(8, 4, 1))
    # torch (O, I, kh, kw) -> flax (kh, kw, I, O)
    to_flax = lambda t: np.transpose(t, (2, 3, 1, 0)) if t.ndim == 4 else t   # noqa: E731
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
    names = [k for k, _ in model.named_parameters()]
    jparams = {k: jnp.asarray(to_flax(p.detach().numpy())) for k, p in model.named_parameters()}
    tx = optax.chain(optax.clip_by_global_norm(35.0),
                     _jax_sgd(jtrainer.yolox_warmcos_schedule(BASE_LR, 4, 1), wd))
    opt = ttrainer.build_yolox_optimizer(
        model, ttrainer.yolox_warmcos_schedule(BASE_LR, 4, 1), "sgd", wd)
    jstate = tx.init(jparams)
    for step in range(4):
        scale = 40.0 if step == 2 else 1.0              # step 2's global norm is over 35
        grads = {k: (rs.randn(*p.shape) * scale).astype(np.float32)
                 for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        upd, jstate = tx.update({k: jnp.asarray(to_flax(g)) for k, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    got = dict(model.named_parameters())
    for k in names:
        w = np.asarray(jparams[k])
        np.testing.assert_allclose(to_flax(got[k].detach().numpy()), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=k)
