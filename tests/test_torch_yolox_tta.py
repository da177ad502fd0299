"""Port parity: YOLOX's test-time augmentation against the JAX package.

``resize_bilinear`` (``F.interpolate`` with antialias) equals
``jax.image.resize(..., "bilinear")`` within 2e-3 on [0, 255] at the TTA's
down- and upscales, borders included (both weight 2-4 taps per axis and sum
in another order; the worst measured is 8e-4). ``make_tta_inference`` at
128x128 with scales (1, .75, 1.25) and flips (six variants, one joint NMS)
gives the JAX function's valid rows on a GN model (dep 0.33 / wid 0.125,
fp32, weights from a seed): the same rows, each with its label, its score
within 1e-4 and its box within 2e-2 px, in any order among scores that tie
within 1e-4 (the model's outputs differ by up to ~1e-4 of their largest
magnitude: fp32 rounding through its GroupNorms; the worst box measured is
1e-2 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.yolox.yolox import make_tta_inference as jax_tta
from gdrnpp_bop2022_torch.models.yolox.yolox import (make_tta_inference, resize_bilinear,
                                                     tta_sizes)
from gdrnpp_bop2022_torch.utils.weights import yolox_state_dict_from_flax
from torch_parity_utils import assert_rows_match, jax_yolox, port_yolox, yolox_images

SCALES = (1.0, 0.75, 1.25)
SCORE_TOL = 1e-4
BOX_TOL = 2e-2          # px


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,w", [(96, 64), (106, 80), (160, 128), (143, 107), (128, 96),
                                 (32, 32)])
def test_resize_matches_jax(h, w):
    x = np.random.RandomState(0).uniform(0, 255, (2, 128, 96, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, h, w, 3), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), h, w).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_tta_sizes():
    assert tta_sizes(640, 640, (1.0, 0.75, 0.83, 1.12, 1.25)) == [
        (640, 640), (480, 480), (544, 544), (704, 704), (800, 800)]
    assert tta_sizes(128, 128, SCALES) == [(128, 128), (96, 96), (160, 160)]


def test_tta_matches_jax():
    jm, params, _ = jax_yolox("GN", False, 0.125, 128, seed=3)
    x = yolox_images(128, seed=7)
    # conf 0.55: fewer candidates than k = 400 and fewer kept rows than
    # max_dets, so no row sits at a cut where a near-tie could swap it
    kw = dict(scales=SCALES, flip=True, conf_thr=0.55, nms_thr=0.65, max_dets=100)
    want = {k: np.asarray(v) for k, v in jax_tta(jm, **kw)(params, jnp.asarray(x)).items()}
    m = port_yolox("GN", False, 0.125, yolox_state_dict_from_flax(params))
    got = {k: v.numpy() for k, v in make_tta_inference(m, **kw)(torch.from_numpy(x)).items()}
    assert got["boxes_xyxy"].shape == want["boxes_xyxy"].shape == (2, 100, 4)
    for b in range(2):
        wv, gv = want["valid"][b], got["valid"][b]
        assert 10 < wv.sum() < 100
        assert_rows_match(*(want[k][b][wv] for k in ("labels", "scores", "boxes_xyxy")),
                          *(got[k][b][gv] for k in ("labels", "scores", "boxes_xyxy")),
                          SCORE_TOL, BOX_TOL)
