"""Port parity: the batched PnP solvers (``ops/pnp.py``) against the JAX package.

Fixtures are tests/test_pnp.py's: known poses, points 0.5-1.2 m away, exact
or low-noise (0.3-0.5 px) correspondences, so LM converges and the
comparison is of final poses. R and t agree within 1e-4. RANSAC gets the
JAX package's own draw (ransac_pnp :184-190 re-run here) as ``idx``; with
its own generator it still rejects the outliers of
tests/test_pnp.py::test_ransac_rejects_outliers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.eval.pose_error import re_batch
from gdrnpp_bop2022_tpu.ops import pnp as JP
from gdrnpp_bop2022_torch.ops import pnp as TP
from test_pnp import _make_case

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _batch(seed, n=64, noise=0.0, B=4):
    rs = np.random.RandomState(seed)
    cases = [_make_case(rs, n=n, noise=noise) for _ in range(B)]
    return [np.stack([c[i] for c in cases]).astype(np.float32) for i in range(5)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def jax_ransac_draw(key, mask, n_hyps, subset_size):
    """ransac_pnp's hypothesis indices (ops/pnp.py:184-190 of the JAX package)."""
    logits = jnp.where(mask, 0.0, -1e9)
    keys = jax.random.split(key, n_hyps)
    return np.asarray(jax.vmap(lambda k: jax.vmap(
        lambda kk, lg: jax.random.categorical(kk, lg, shape=(subset_size,)))(
            jax.random.split(k, mask.shape[0]), logits))(keys))


def test_rodrigues_and_log_match_jax():
    rs = np.random.RandomState(0)
    w = (rs.randn(16, 3) * rs.uniform(0.01, 2.5, (16, 1))).astype(np.float32)
    Rj = JP._rodrigues(jnp.asarray(w))
    np.testing.assert_allclose(TP._rodrigues(_t(w)).numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(TP._log_so3(_t(np.asarray(Rj))).numpy(),
                               np.asarray(JP._log_so3(Rj)), atol=1e-5)


def test_jacobian_matches_jax_autodiff():
    """The closed-form LM Jacobian against jax.jacfwd of the JAX package's
    residuals, at rotations from 1e-4 to 2.5 rad."""
    Rg, tg, p3, p2, K = _batch(6, n=32)
    rs = np.random.RandomState(6)
    w = (rs.randn(4, 3) * np.array([[1e-4], [0.05], [1.0], [2.5]])).astype(np.float32)
    params = np.concatenate([w, tg], 1)
    p2n = np.asarray(JP.normalize_points_2d(jnp.asarray(p2), jnp.asarray(K)))
    want = np.stack([np.asarray(jax.jacfwd(lambda q: JP._residuals(
        q[None], jnp.asarray(p3[b])[None], jnp.asarray(p2n[b])[None])[0])(
            jnp.asarray(params[b]))) for b in range(4)])                 # (B, N, 2, 6)
    got = TP._jacobian(_t(params), _t(p3)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_dlt_and_lm_match_jax(noise):
    Rg, tg, p3, p2, K = _batch(1, n=128, noise=noise)
    p2n = TP.normalize_points_2d(_t(p2), _t(K))
    p2n_j = JP.normalize_points_2d(jnp.asarray(p2), jnp.asarray(K))
    np.testing.assert_allclose(p2n.numpy(), np.asarray(p2n_j), rtol=1e-6)
    w = np.random.RandomState(2).uniform(0.2, 1.0, p3.shape[:2]).astype(np.float32)
    for weights in (None, w):
        want = JP.dlt_pnp(jnp.asarray(p3), p2n_j,
                          None if weights is None else jnp.asarray(weights))
        got = TP.dlt_pnp(_t(p3), p2n, None if weights is None else _t(weights))
        assert got[0].dtype == torch.float32
        _close(got, want)
        R0, t0 = want
        want = JP.lm_refine_pnp(R0, t0, jnp.asarray(p3), p2n_j,
                                None if weights is None else jnp.asarray(weights), iters=15)
        got = TP.lm_refine_pnp(_t(R0), _t(t0), _t(p3), p2n,
                               None if weights is None else _t(weights), iters=15)
        _close(got, want)
    np.testing.assert_allclose(got[1].numpy(), tg, atol=0.01)


def test_dlt_sign_and_reflection_guard():
    """A flipped 2D-3D system still gives a proper rotation in front of the
    camera: the centroid-depth sign fix and det(R) = +1."""
    Rg, tg, p3, p2, K = _batch(3)
    R, t = TP.dlt_pnp(_t(p3), TP.normalize_points_2d(_t(p2), _t(K)))
    assert (t[:, 2] > 0).all()
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(R.numpy(), Rg, atol=1e-3)


def test_uncertainty_pnp_matches_jax():
    """tests/test_pnp.py::test_uncertainty_pnp_downweights_bad_points."""
    rs = np.random.RandomState(3)
    Rg, tg, p3, p2, K = _make_case(rs, n=96, noise=0.2)
    p2 = p2.copy()
    p2[:20] += 50.0
    w = np.ones((96, 2), np.float32)
    w[:20] = 1e-4
    for wt in (w, w[:, 0]):
        want = JP.uncertainty_pnp(*(jnp.asarray(a)[None] for a in (p3, p2, wt, K)))
        got = TP.uncertainty_pnp(*(_t(a)[None] for a in (p3, p2, wt, K)))
        _close(got, want)
        assert float(re_batch(jnp.asarray(got[0].numpy()), jnp.asarray(Rg)[None])[0]) < 2.0


def _outlier_case():
    """tests/test_pnp.py::test_ransac_rejects_outliers: 38 of 128 points
    moved up to 100 px."""
    rs = np.random.RandomState(2)
    Rg, tg, p3, p2, K = _make_case(rs, n=128, noise=0.3)
    p2 = p2.copy()
    p2[:38] += rs.uniform(-100, 100, (38, 2))
    return Rg, tg, p3, p2, K


def test_ransac_with_the_jax_draw_matches_jax():
    Rg, tg, p3, p2, K = _outlier_case()
    mask = np.ones((2, 128), bool)
    mask[1, ::3] = False
    args = [np.stack([a, a]) for a in (p3, p2, K)]
    key = jax.random.PRNGKey(0)
    want = JP.ransac_pnp(key, *(jnp.asarray(a) for a in args), mask=jnp.asarray(mask),
                         n_hyps=32, subset_size=8)
    idx = jax_ransac_draw(key, jnp.asarray(mask), 32, 8)
    got = TP.ransac_pnp(*(_t(a) for a in args), mask=_t(mask), idx=_t(idx))
    _close(got[:2], want[:2])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


def test_ransac_with_its_own_generator_rejects_outliers():
    Rg, tg, p3, p2, K = _outlier_case()
    g = torch.Generator().manual_seed(0)
    R, t, frac = TP.ransac_pnp(_t(p3)[None], _t(p2)[None], _t(K)[None], n_hyps=128,
                               subset_size=8, generator=g)
    assert float(re_batch(jnp.asarray(R.numpy()), jnp.asarray(Rg)[None])[0]) < 3.0
    assert np.linalg.norm(t[0].numpy() - tg) < 0.02
    assert float(frac[0]) > 0.5


def test_hypotheses_draw_valid_points_or_any():
    """Uniform with replacement over the valid points; a row without any
    valid point draws over all of them (the JAX draw's logits 0 / -1e9)."""
    mask = torch.zeros(3, 50, dtype=torch.bool)
    mask[0, 10:20] = True
    mask[1] = True
    g = torch.Generator().manual_seed(1)
    idx = TP.ransac_hypotheses(mask, 200, 8, g)
    assert idx.shape == (200, 3, 8)
    assert ((idx[:, 0] >= 10) & (idx[:, 0] < 20)).all()
    for row in (1, 2):
        assert len(idx[:, row].unique()) == 50
    same = TP.ransac_hypotheses(mask, 200, 8, torch.Generator().manual_seed(1))
    assert torch.equal(idx, same)


def test_lm_keeps_the_pose_without_weights():
    """All weights 0: the system is singular (H = 1e-12 I, g = 0), no step
    is taken and no error is raised."""
    Rg, tg, p3, p2, K = _batch(5, B=2)
    R0 = torch.from_numpy(Rg)
    t0 = torch.from_numpy(tg + 0.01)
    R, t = TP.lm_refine_pnp(R0, t0, _t(p3), TP.normalize_points_2d(_t(p2), _t(K)),
                            weights=torch.zeros(2, 64), iters=5)
    np.testing.assert_allclose(t.numpy(), t0.numpy(), atol=1e-6)
    np.testing.assert_allclose(R.numpy(), Rg, atol=1e-6)


@pytest.mark.gpu
def test_solvers_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    Rg, tg, p3, p2, K = _batch(1, n=128, noise=0.5)
    cpu = [_t(a) for a in (p3, p2, K)]
    gpu = [a.cuda() for a in cpu]
    for fn in (lambda a: TP.uncertainty_pnp(a[0], a[1], torch.ones_like(a[1]), a[2]),
               lambda a: TP.dlt_pnp(a[0], TP.normalize_points_2d(a[1], a[2]))):
        for g, c in zip(fn(gpu), fn(cpu)):
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=TOL)
    idx = torch.randint(0, 128, (16, 4, 8), generator=torch.Generator().manual_seed(0))
    got = TP.ransac_pnp(*gpu, idx=idx.cuda())
    want = TP.ransac_pnp(*cpu, idx=idx)
    for g, c in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=TOL)
    g = torch.Generator(device="cuda").manual_seed(0)
    assert TP.ransac_hypotheses(gpu[0][..., 0] > -1, 8, 8, g).device.type == "cuda"
