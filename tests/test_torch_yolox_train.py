"""Port parity: YOLOX training's parts (slice 4b) against the JAX package on the CPU.

  * BatchNorm in training mode (``norm="BN"``): outputs and running mean and
    variance after one and three training-mode forwards equal flax's
    ``batch_stats`` within 1e-6 relative, on 2 x 2 x 2 maps where the
    unbiased variance would be 8/7 of the biased one; the gradients through
    the batch statistics within 1e-5 of each one's largest;
  * simOTA on tie-free random fixtures (continuous predictions, distinct GT
    centres; padded GTs, an image without GT, a GT box that holds no anchor
    centre): ``fg`` and ``matched_gt`` exactly, ``matched_iou`` within 1e-6;
  * ``yolox_loss`` without and with L1 on the same raw per-level outputs:
    every loss within 1e-5 relative, the gradient w.r.t. every level within
    1e-5 of its largest magnitude (a detached ``matched_iou``, the
    reference's choice, moves the regression channels' gradient past that);
  * ``yolox_warmcos_schedule`` over whole runs: the warmup bit for bit, the
    cosine within 1e-7 relative plus 2.5e-7 x base_lr (XLA's fp32 cos is one
    ulp off the correctly rounded one, which the port computes, for ~1% of
    arguments; near the anneal's end, where 1 + cos nearly cancels, one ulp
    of cos is up to 6e-7 of the rate);
  * ``multiscale_resize`` up and down within 8e-4 on [0, 255] (the bilinear
    kernels' sums, ``tests/test_torch_yolox_tta.py``), boxes within 1e-6;
  * ``precise_bn_stats`` over three batches within 1e-5 relative of the JAX
    result (which recovers each batch's statistics by inverting the
    momentum update) on a BN CSPLayer, and on a whole BN YOLOX equal to the
    plain average of each batch's statistics (across the whole model, fp32
    convolutions summed in oneDNN's and XLA's orders move the head's
    statistics over 2 x 2 maps by up to 4e-4 of their largest);
  * ``init_yolox_weights`` draws flax's default initialisers.
The train step itself is ``tests/test_torch_yolox_step.py``; ``train_yolox``,
its CLI and ``test_yolox --ckpt`` are ``tests/test_torch_yolox_trainer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.engine import yolox_trainer as jtrainer
from gdrnpp_bop2022_tpu.models.yolox import darknet as jdark
from gdrnpp_bop2022_tpu.models.yolox import head as jhead
from gdrnpp_bop2022_torch.engine import yolox_trainer as ttrainer
from gdrnpp_bop2022_torch.models.yolox import darknet as tdark
from gdrnpp_bop2022_torch.models.yolox import head as thead
from gdrnpp_bop2022_torch.models.yolox.yolox import YOLOX
from torch_parity_utils import yolox_images

STRIDES = (8, 16, 32)
NC = 3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- BatchNorm in training mode ------------------------------------------------

@pytest.mark.parametrize("n_forwards", [1, 3])
def test_bn_training_matches_flax(n_forwards):
    """A BN ConvBnAct (flax nn.BatchNorm momentum 0.97, eps 1e-3) in
    training mode, fed 2 x 2 x 2 maps (n = 8: torch's own BatchNorm2d would
    update the variance with 8/7 of it)."""
    rs = np.random.RandomState(n_forwards)
    xs = [rs.randn(2, 2, 2, 3).astype(np.float32) * 2 + 1 for _ in range(n_forwards)]
    jm = jdark.ConvBnAct(4, 1, norm="BN", dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    kernel = rs.randn(1, 1, 3, 4).astype(np.float32)
    scale, bias = (1 + 0.1 * rs.randn(4)).astype(np.float32), (0.1 * rs.randn(4)).astype(np.float32)
    stats = {"BatchNorm_0": {"mean": (0.1 * rs.randn(4)).astype(np.float32),
                             "var": rs.uniform(0.5, 2, 4).astype(np.float32)}}
    params = {"Conv_0": {"kernel": kernel}, "BatchNorm_0": {"scale": scale, "bias": bias}}
    assert jax.tree.structure(params) == jax.tree.structure(v["params"])

    tm = tdark.BaseConv(3, 4, 1, norm="BN", dtype=torch.float32)
    tm.load_state_dict({"conv.weight": torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()),
                        "bn.weight": torch.from_numpy(scale), "bn.bias": torch.from_numpy(bias),
                        "bn.running_mean": torch.from_numpy(stats["BatchNorm_0"]["mean"].copy()),
                        "bn.running_var": torch.from_numpy(stats["BatchNorm_0"]["var"].copy()),
                        "bn.num_batches_tracked": torch.zeros((), dtype=torch.int64)})
    tm.train()
    train_apply = jax.jit(lambda p, st, x: jm.apply({"params": p, "batch_stats": st}, x,
                                                    mutable=["batch_stats"]))
    for x in xs:
        want, upd = train_apply(params, stats, jnp.asarray(x))
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(stats["BatchNorm_0"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(stats["BatchNorm_0"]["var"]),
                               rtol=1e-6)
    # eval mode reads the running statistics, as flax's use_running_average
    tm.eval()
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
    with torch.no_grad():
        got = tm(torch.from_numpy(xs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tm.train()
    # the gradient through the batch statistics, w.r.t. the input and the
    # parameters, of a weighted sum of the outputs
    r = rs.randn(2, 2, 2, 4).astype(np.float32)

    def jsum(p, x):
        out, _ = train_apply(p, stats, x)
        return jnp.sum(out * r)

    jgp, jgx = jax.jit(jax.grad(jsum, argnums=(0, 1)))(params, jnp.asarray(xs[-1]))
    x = torch.from_numpy(xs[-1]).permute(0, 3, 1, 2).requires_grad_(True)
    (tm(x).permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    for got, want in ((x.grad.permute(0, 2, 3, 1), jgx),
                      (tm.conv.weight.grad.permute(2, 3, 1, 0), jgp["Conv_0"]["kernel"]),
                      (tm.bn.weight.grad, jgp["BatchNorm_0"]["scale"]),
                      (tm.bn.bias.grad, jgp["BatchNorm_0"]["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# --- simOTA and the loss ---------------------------------------------------------

def _raw_outputs(rs, B, size, nc=NC):
    """Per-level raw outputs (B, H, W, 5 + C): xy offsets, log sizes around
    a few strides, logits; continuous, so no two costs tie."""
    outs = []
    for s in STRIDES:
        h = size // s
        o = rs.randn(B, h, h, 5 + nc).astype(np.float32)
        o[..., 0:2] = rs.uniform(-0.5, 1.5, (B, h, h, 2))
        o[..., 2:4] = rs.normal(1.0, 0.6, (B, h, h, 2))
        outs.append(o)
    return outs


def _gts(rs, B, G, size, n_valid):
    """Padded GTs with distinct centres; image b has n_valid[b] of them.
    GT 0 of image 0 is a 3x3 box between anchor centres (none inside it)."""
    boxes = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        boxes[b, :, :2] = rs.uniform(0.1 * size, 0.9 * size, (G, 2))
        boxes[b, :, 2:] = rs.uniform(6.0, 0.45 * size, (G, 2))
    boxes[0, 0] = (8.0 + 1.3, 8.0 + 1.7, 3.0, 3.0)       # between the centres 4 and 12
    labels = rs.randint(0, NC, (B, G)).astype(np.int32)
    valid = np.arange(G)[None, :] < np.asarray(n_valid)[:, None]
    return boxes, labels, valid


@pytest.fixture(scope="module")
def fixture():
    rs = np.random.RandomState(11)
    size, B, G = 128, 3, 7
    outs = _raw_outputs(rs, B, size)
    boxes, labels, valid = _gts(rs, B, G, size, n_valid=(5, 0, 7))
    return outs, boxes, labels, valid


def _decoded(outs, mod):
    if mod is jhead:
        flat, grids, st = jhead.flatten_outputs([jnp.asarray(o) for o in outs], STRIDES)
    else:
        flat, grids, st = thead.flatten_outputs([torch.from_numpy(o) for o in outs], STRIDES)
    return (*mod.decode_outputs(flat, grids, st), grids, st)


def test_simota_matches_jax(fixture):
    outs, boxes, labels, valid = fixture
    bd, ol, cl, grids, st = _decoded(outs, jhead)
    want = jax.jit(jax.vmap(lambda a, b, c, d, e, f: jhead.simota_assign(
        a, b, c, grids, st, d, e, f)))(bd, ol, cl, boxes, labels, valid)
    bd, ol, cl, grids, st = _decoded(outs, thead)
    got = thead.simota_assign(bd, ol, cl, grids, st, torch.from_numpy(boxes),
                              torch.from_numpy(labels), torch.from_numpy(valid))
    fg, mg, miou = (np.asarray(w) for w in want)
    assert fg[0].sum() > 0 and fg[2].sum() > 0 and fg[1].sum() == 0
    assert (mg[0][fg[0]] == 0).any(), "the GT without an anchor centre inside got no anchor"
    np.testing.assert_array_equal(got[0].numpy(), fg)
    np.testing.assert_array_equal(got[1].numpy(), mg)
    np.testing.assert_allclose(got[2].numpy(), miou, rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_l1", [False, True])
def test_yolox_loss_and_grads_match_jax(fixture, use_l1):
    outs, boxes, labels, valid = fixture

    def jloss(os_):
        d = jhead.yolox_loss(os_, STRIDES, boxes, labels, valid, use_l1=use_l1)
        return d["total_loss"], d

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o.copy()).requires_grad_(True) for o in outs]
    got = thead.yolox_loss(touts, STRIDES, torch.from_numpy(boxes), torch.from_numpy(labels),
                           torch.from_numpy(valid), use_l1=use_l1)
    got["total_loss"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
    for t, g in zip(touts, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


# --- schedule, resize, precise BN, init -------------------------------------------

@pytest.mark.parametrize("base_lr,total,warmup,start", [
    (1e-3 / 64 * 32, 400, 37, 0.0), (0.02, 120, 500, 0.0), (0.01, 1000, 100, 1e-4)])
def test_warmcos_schedule_matches_jax(base_lr, total, warmup, start):
    kw = dict(warmup_iters=min(warmup, total), warmup_lr_start=start)
    js = jtrainer.yolox_warmcos_schedule(base_lr, total, **kw)
    ts = ttrainer.yolox_warmcos_schedule(base_lr, total, **kw)
    steps = np.arange(0, total + 3)
    want = np.asarray(jax.vmap(js)(jnp.asarray(steps)))
    got = np.array([ts(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=2.5e-7 * base_lr)
    np.testing.assert_array_equal(got[:warmup + 1], want[:warmup + 1])


@pytest.mark.parametrize("size", [96, 32, 64])
def test_multiscale_resize_matches_jax(size):
    rs = np.random.RandomState(size)
    imgs = rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    boxes = rs.uniform(1, 60, (2, 5, 4)).astype(np.float32)
    wi, wb = jtrainer.multiscale_resize(jnp.asarray(imgs), jnp.asarray(boxes), size)
    gi, gb = ttrainer.multiscale_resize(torch.from_numpy(imgs), torch.from_numpy(boxes), size)
    assert tuple(gi.shape) == (2, size, size, 3)
    np.testing.assert_allclose(gi.float().numpy(), np.asarray(wi, np.float32), rtol=0, atol=8e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6)


def test_precise_bn_matches_jax():
    """A BN CSPLayer (five BNs) on 2 x 8 x 8 maps, three batches."""
    from gdrnpp_bop2022_torch.utils.weights import _yolox_node
    from torch_parity_utils import _random_stats, random_like_tree
    rs = np.random.RandomState(3)
    batches = [rs.randn(2, 8, 8, 6).astype(np.float32) * (1 + i) + i for i in range(3)]
    jm = jdark.CSPLayer(8, n=1, norm="BN", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(batches[0])), jax.random.PRNGKey(0))
    params = random_like_tree(shapes["params"], 4)
    stats = _random_stats(shapes["batch_stats"], 5)
    want = jtrainer.precise_bn_stats(jm, params, stats, [jnp.asarray(b) for b in batches])

    def port_sd(p, s):
        out = {}
        _yolox_node(p, s, "", out)
        return {k[1:]: torch.from_numpy(np.array(v)) for k, v in out.items()}

    sd = port_sd(params, stats)
    m = tdark.CSPLayer(6, 8, 1, norm="BN", dtype=torch.float32)
    m.load_state_dict(sd, strict=True)
    weights = {k: v for k, v in sd.items() if k in dict(m.named_parameters())}
    got = ttrainer.precise_bn_stats(
        m, weights, [torch.from_numpy(b).permute(0, 3, 1, 2) for b in batches])
    want_sd = port_sd(params, want)
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert sorted(got) == sorted(keys) and len(keys) == 10
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want_sd[k].numpy(), rtol=1e-5, err_msg=k)
    # the model's own statistics are left as they were; no batches change nothing
    assert all(torch.equal(m.state_dict()[k], sd[k]) for k in keys)
    assert ttrainer.precise_bn_stats(m, weights, []) == {}


def test_precise_bn_whole_model_is_the_batch_average():
    """On a whole BN YOLOX, precise_bn_stats is the plain average of each
    batch's statistics, as a training-mode forward from zeroed statistics at
    momentum 1 leaves them."""
    m = YOLOX(NC, 0.33, 0.125, norm="BN", dtype=torch.float32)
    ttrainer.init_yolox_weights(m, seed=2)
    batches = [torch.from_numpy(yolox_images(64, seed=s, n=2)) for s in (5, 6, 7)]
    weights = {k: v.detach().clone() for k, v in m.named_parameters()}
    got = ttrainer.precise_bn_stats(m, weights, batches)
    bns = [mod for mod in m.modules() if isinstance(mod, tdark.BatchNormFp32)]
    sums = {}
    m.train()
    for b in batches:
        for mod in bns:
            mod.momentum = 1.0
        with torch.no_grad():
            m(b)
        for k, v in m.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                sums[k] = sums.get(k, 0) + v
    assert sorted(got) == sorted(sums) and len(got) == 2 * len(bns) > 100
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), (sums[k] / 3).numpy(), rtol=1e-6,
                                   atol=1e-6 * float(sums[k].abs().max()), err_msg=k)


def test_init_draws_flax_defaults():
    m = YOLOX(NC, 0.33, 0.125, norm="BN", dtype=torch.float32)
    ttrainer.init_yolox_weights(m, seed=4)
    w = m.backbone.backbone.dark3[0].conv.weight.detach()   # (O, I, 3, 3)
    std = np.sqrt(1.0 / w[0].numel())
    assert abs(float(w.std()) - std) < 0.1 * std and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
    assert float(m.head.cls_preds[0].bias.detach().abs().max()) == 0.0
    bn = m.backbone.backbone.stem.conv.bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and float(bn.running_var.min()) == 1.0
    m2 = YOLOX(NC, 0.33, 0.125, norm="BN", dtype=torch.float32)
    ttrainer.init_yolox_weights(m2, seed=4)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                  m2.state_dict().values()))
