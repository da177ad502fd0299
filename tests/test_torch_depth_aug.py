"""Port parity: depth augmentation and smoothing against the JAX package
(``ops/depth_aug.py``).

``gdrn_depth_aug`` and ``add_noise_depth`` take the draws that the JAX
functions make from their keys (``split(key, 6)`` and ``split(key, 3)``,
replayed here) and must agree at 1e-6; ``bilateral_depth_smooth`` (no
draws) at 1e-6. The draw functions' coins are held to their probabilities
by a seeded count within 5 binomial standard deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops import depth_aug as jda
from gdrnpp_bop2022_torch.ops import depth_aug as tda

B, H, W = 6, 20, 28


def _depth(seed=0):
    rs = np.random.RandomState(seed)
    d = rs.uniform(0.5, 1.5, (B, H, W)).astype(np.float32)
    d[rs.rand(B, H, W) < 0.3] = 0.0                      # holes the fill reaches
    return d


def jax_gdrn_depth_draws(key, shape, fill_std=0.1, drop_prob=0.5, drop_ratio=0.2,
                         noise_prob=0.9, noise_level=0.005):
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    b = shape[0]
    level = jax.random.uniform(k5, (b, 1, 1), maxval=noise_level)
    return {"fill": fill_std * jax.random.normal(k1, shape),
            "do_drop": jax.random.uniform(k2, (b, 1, 1)) < drop_prob,
            "keep": jax.random.uniform(k3, shape) > drop_ratio,
            "do_noise": jax.random.uniform(k4, (b, 1, 1)) < noise_prob,
            "gauss": level * jax.random.normal(k6, shape)}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gdrn_depth_aug_matches_jax(seed):
    depth = _depth(seed)
    key = jax.random.PRNGKey(seed)
    kw = dict(drop_prob=0.5, drop_ratio=0.2, noise_prob=0.9, noise_level=0.01)
    want = np.asarray(jda.gdrn_depth_aug(key, jnp.asarray(depth), **kw))
    draws = jax_gdrn_depth_draws(key, depth.shape, **kw)
    got = tda.gdrn_depth_aug(torch.from_numpy(depth), _t(draws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not np.array_equal(got, depth)


def test_add_noise_depth_matches_jax():
    depth = _depth(3)
    key = jax.random.PRNGKey(7)
    kw = dict(noise_std=0.005, hole_prob=0.1, scale_std=0.005)      # hole_size 4
    want = np.asarray(jda.add_noise_depth(key, jnp.asarray(depth), **kw))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"scale": 1.0 + 0.005 * jax.random.normal(k1, (B, 1, 1)),
             "noise": 0.005 * jax.random.normal(k2, depth.shape),
             "holes": np.asarray(jax.random.bernoulli(k3, 0.1, (B, H // 4, W // 4, 1)),
                                 np.float32)[..., 0]}
    got = tda.add_noise_depth(torch.from_numpy(depth), _t(draws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == 0).mean() > (depth == 0).mean()          # the holes fired


def test_bilateral_depth_smooth_matches_jax():
    depth = _depth(4)
    want = np.asarray(jda.bilateral_depth_smooth(jnp.asarray(depth), radius=2))
    got = tda.bilateral_depth_smooth(torch.from_numpy(depth), radius=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _rate_ok(x, p, n):
    return abs(float(x) - p) <= 5 * np.sqrt(p * (1 - p) / n)


def test_draw_rates():
    n = 4000
    g = torch.Generator().manual_seed(99)
    d = tda.draw_gdrn_depth_aug(g, (n, 4, 4), drop_prob=0.5, drop_ratio=0.2, noise_prob=0.9,
                                noise_level=0.01)
    assert _rate_ok(d["do_drop"].float().mean(), 0.5, n)
    assert _rate_ok(d["do_noise"].float().mean(), 0.9, n)
    assert _rate_ok(d["keep"].float().mean(), 0.8, d["keep"].numel())
    assert 0.0 < float(d["gauss"].abs().max()) < 0.01 * 6
    a = tda.draw_add_noise_depth(g, (n, 8, 8), hole_prob=0.05)
    assert _rate_ok(a["holes"].mean(), 0.05, a["holes"].numel())
