"""Port parity: YOLOX's parts against the JAX package: the backbone's stages,
the decode and the static-shape NMS.

At dep 0.33 / wid 0.125, GN, dense and depthwise, each backbone stage fed
the JAX model's input to it gives the JAX stage's output to 1e-5 of its
largest magnitude (the whole GN model at this width amplifies fp32 rounding
past 1e-4: ``tests/test_torch_yolox.py`` holds it at yolox_s's widths).
On identical raw head outputs (B = 2 at 128x128, 3 classes, boxes that
overlap their neighbours so that suppressions chain), ``flatten_outputs``,
``decode_outputs`` and ``pairwise_iou`` agree to fp32 rounding, and
``postprocess_nms`` gives the JAX package's valid rows: labels exactly, boxes
and scores to 1e-5. The fixed point that replaces the sequential scan equals
that scan on random and adversarial suppression patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.yolox import head as jhead
from gdrnpp_bop2022_tpu.models.yolox.yolox import postprocess_nms as jax_nms
from gdrnpp_bop2022_torch.models.yolox import head as thead
from gdrnpp_bop2022_torch.models.yolox import yolox as tyolox
from gdrnpp_bop2022_torch.utils.weights import yolox_state_dict_from_flax
from torch_parity_utils import jax_yolox, port_yolox, yolox_images

NC = 3
NMS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("depthwise", [False, True])
def test_gn_stages_match_jax_given_the_same_input(depthwise):
    """At wid 0.125 each backbone stage, fed the JAX model's input to it,
    gives the JAX stage's output to 1e-5 of its largest magnitude."""
    jm, params, _ = jax_yolox("GN", depthwise, 0.125, 64)
    x = yolox_images(64)
    _, st = jax.jit(lambda v, xx: jm.apply(v, xx, capture_intermediates=True))(
        {"params": params}, jnp.asarray(x))
    inter = {k: np.asarray(v["__call__"][0])
             for k, v in st["intermediates"]["pafpn"]["backbone"].items() if k != "__call__"}
    bb = port_yolox("GN", depthwise, 0.125, yolox_state_dict_from_flax(params)).backbone.backbone
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)     # noqa: E731
    stages = [("stem", bb.stem, x), ("dark2_conv", bb.dark2[0], inter["stem"]),
              ("dark2_csp", bb.dark2[1], inter["dark2_conv"]),
              ("dark3_csp", bb.dark3[1], inter["dark3_conv"]),
              ("dark4_csp", bb.dark4[1], inter["dark4_conv"]),
              ("dark5_spp", bb.dark5[1], inter["dark5_conv"]),
              ("dark5_csp", bb.dark5[2], inter["dark5_spp"])]
    for name, mod, inp in stages:
        with torch.no_grad():
            got = mod(nchw(inp)).permute(0, 2, 3, 1).numpy()
        want = inter[name]
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


def _raw_levels(seed, size=128, B=2):
    """Raw head outputs whose boxes overlap their neighbours' (4-6 strides
    wide, centres jittered), so that suppression chains form; logits from
    N(0, 1.5): no two scores tie."""
    rs = np.random.RandomState(seed)
    outs = []
    for s in (8, 16, 32):
        h = size // s
        o = np.empty((B, h, h, 5 + NC), np.float32)
        o[..., 0:2] = rs.uniform(-0.5, 1.5, (B, h, h, 2))
        o[..., 2:4] = np.log(rs.uniform(4.0, 6.0, (B, h, h, 2)))
        o[..., 4:] = 1.5 * rs.randn(B, h, h, 1 + NC)
        outs.append(o)
    return outs


def test_flatten_decode_iou_match_jax():
    outs = _raw_levels(0)
    jf, jg, js = jhead.flatten_outputs([jnp.asarray(o) for o in outs], (8, 16, 32))
    tf, tg, ts = thead.flatten_outputs([torch.from_numpy(o) for o in outs], (8, 16, 32))
    for a, b in ((jf, tf), (jg, tg), (js, ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jd = jhead.decode_outputs(jf, jg, js)
    td = thead.decode_outputs(tf, tg, ts)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    jb = jhead._cxcywh_to_xyxy(jd[0][0])
    tb = thead.cxcywh_to_xyxy(td[0][0])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(thead.pairwise_iou(tb, tb).numpy(),
                               np.asarray(jhead.pairwise_iou(jb, jb)), atol=1e-6)


def assert_nms_rows_equal(want, got, tol=NMS_TOL):
    """Valid rows: equal counts, labels exactly, boxes and scores to tol."""
    for b in range(want["valid"].shape[0]):
        wv, gv = np.asarray(want["valid"][b]), np.asarray(got["valid"][b])
        assert wv.sum() == gv.sum() and wv[:wv.sum()].all() and gv[:gv.sum()].all()
        np.testing.assert_array_equal(np.asarray(got["labels"][b])[gv],
                                      np.asarray(want["labels"][b])[wv])
        np.testing.assert_allclose(np.asarray(got["boxes_xyxy"][b])[gv],
                                   np.asarray(want["boxes_xyxy"][b])[wv], rtol=tol, atol=tol)
        np.testing.assert_allclose(np.asarray(got["scores"][b])[gv],
                                   np.asarray(want["scores"][b])[wv], rtol=tol, atol=tol)


@pytest.mark.parametrize("max_dets,conf_thr", [(8, 0.01), (100, 0.3), (100, 0.01)])
def test_nms_matches_jax(max_dets, conf_thr):
    """k = 4 max_dets = 32 < A = 336, and k = A < 400; a threshold that
    leaves scores of 0 among the candidates. The raw rows suppress in
    chains: every case keeps fewer rows than it has candidates above the
    threshold."""
    outs = _raw_levels(1)
    jf, jg, js = jhead.flatten_outputs([jnp.asarray(o) for o in outs], (8, 16, 32))
    want = jax_nms(jf, jg, js, conf_thr=conf_thr, nms_thr=0.65, max_dets=max_dets)
    tf, tg, ts = thead.flatten_outputs([torch.from_numpy(o) for o in outs], (8, 16, 32))
    got = tyolox.postprocess_nms(tf, tg, ts, conf_thr=conf_thr, nms_thr=0.65,
                                 max_dets=max_dets)
    assert got["boxes_xyxy"].shape == tuple(want["boxes_xyxy"].shape)
    assert_nms_rows_equal(want, {k: v.numpy() for k, v in got.items()})
    n_kept = int(got["valid"].sum())
    assert 0 < n_kept < min(4 * max_dets, tf.shape[1]) * 2


def _sequential_greedy(suppress, valid):
    kept = np.zeros_like(valid)
    for b in range(valid.shape[0]):
        for j in range(valid.shape[1]):
            kept[b, j] = valid[b, j] and not (suppress[b, :j, j] & kept[b, :j]).any()
    return kept


def test_fixed_point_equals_the_sequential_scan():
    """Random suppression patterns and a chain of 40 (each candidate
    overlapping the next: the kept set alternates, and the fixed point needs
    40 steps, ten host checks)."""
    rs = np.random.RandomState(0)
    k = 48
    upper = np.triu(np.ones((k, k), bool), 1)
    sup = (rs.uniform(size=(3, k, k)) < 0.08) & upper
    chain = np.zeros((k, k), bool)
    chain[np.arange(39), np.arange(1, 40)] = True
    sup = np.concatenate([sup, chain[None]])
    valid = rs.uniform(size=(4, k)) < 0.9
    valid[3] = True
    got = tyolox._greedy_keep(torch.from_numpy(sup), torch.from_numpy(valid)).numpy()
    want = _sequential_greedy(sup, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[3, :40], np.arange(40) % 2 == 0)
