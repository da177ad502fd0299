"""Port parity: depth refinement, PnP from dense predictions, dense
correspondences and crop cameras.

``depth_refine_batch`` runs on the ``_setup`` scenes of tests/test_pnp_eval.py
(a cube rendered at its GT pose, the translation pushed off by a few cm)
through the JAX package and the port (plain rasterizer on the CPU); the
refined translations agree within 1e-5 m, and the port keeps the property
that test asserts: a 4 cm z error falls below 30% of itself. The three
``pose_from_dense_*`` paths run on the same scenes (the rendered XYZ and
mask: what a perfect network would give) and agree with the JAX package
within 1e-4 on R and t, RANSAC given the JAX draw; both net_iter guards
hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from gdrnpp_bop2022_tpu.eval import pnp_eval as JE
from gdrnpp_bop2022_tpu.eval.pnp_eval import dense_correspondences as j_dense
from gdrnpp_bop2022_tpu.eval.pnp_eval import depth_refine_batch as j_refine
from gdrnpp_bop2022_tpu.geometry.camera import centered_crop_K as j_crop_K
from gdrnpp_bop2022_tpu.geometry.camera import get_K_crop_resize as j_K_crop
from gdrnpp_bop2022_torch.eval import pnp_eval as TE
from gdrnpp_bop2022_torch.eval.pnp_eval import dense_correspondences, depth_refine_batch
from gdrnpp_bop2022_torch.geometry.camera import centered_crop_K, get_K_crop_resize
from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda
from test_pnp_eval import _setup
from test_torch_pnp import jax_ransac_draw

_OFFSETS = ((0.0, 0.0, 0.04), (0.0, 0.0, -0.03), (0.004, -0.003, 0.02))


def _batch(seeds=(2, 5, 9)):
    """One ROI per (seed, offset): stacked _setup scenes with t perturbed."""
    ss = [_setup(seed=s) for s in seeds]
    t_bad = np.stack([s["t"] + np.asarray(o, np.float32) for s, o in zip(ss, _OFFSETS)])
    keys = ("R", "mask", "xyz_norm", "depth", "K", "center", "verts", "faces", "extent")
    b = {k: np.stack([s[k] for s in ss]) for k in keys}
    b["scale"] = np.array([s["scale"] for s in ss], np.float32)
    return ss, t_bad.astype(np.float32), b


def _args(t_bad, b, conv):
    return [conv(a) for a in (b["R"], t_bad, b["mask"], b["xyz_norm"], b["depth"], b["K"],
                              b["center"], b["scale"], b["verts"], b["faces"],
                              b["extent"])]


@pytest.mark.parametrize("iters,threshold", [(2, 0.8), (3, 0.5)])
def test_depth_refine_matches_jax(iters, threshold):
    ss, t_bad, b = _batch()
    want = np.asarray(j_refine(*_args(t_bad, b, jnp.asarray), iters=iters,
                               threshold=threshold, out_res=32))
    before = render_depth_xyz_cuda.launches
    got = depth_refine_batch(*_args(t_bad, b, torch.from_numpy), iters=iters,
                             threshold=threshold, out_res=32)
    assert render_depth_xyz_cuda.launches == before     # CPU: the plain version
    assert got.shape == (3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(got.numpy() - t_bad).max() > 1e-3      # it did move t


def test_depth_refine_fixes_z_offset():
    _, t_bad, b = _batch()
    t_ref = depth_refine_batch(*_args(t_bad, b, torch.from_numpy), iters=2,
                               out_res=32).numpy()
    t_gt = np.stack([_setup(seed=s)["t"] for s in (2, 5, 9)])
    err_before = np.abs(t_bad[:, 2] - t_gt[:, 2])
    err_after = np.abs(t_ref[:, 2] - t_gt[:, 2])
    assert (err_after < err_before * 0.3).all(), (err_before, err_after)


def test_depth_refine_keeps_t_without_support():
    """No sensor depth: nothing to compare, t stays as it was."""
    _, t_bad, b = _batch()
    b["depth"] = np.zeros_like(b["depth"])
    got = depth_refine_batch(*_args(t_bad, b, torch.from_numpy), out_res=32)
    np.testing.assert_array_equal(got.numpy(), t_bad)


def test_dense_correspondences_match_jax():
    rs = np.random.RandomState(1)
    mask = rs.rand(2, 8, 8).astype(np.float32)
    xyz = rs.rand(2, 8, 8, 3).astype(np.float32)
    xyz[0, :2] = 0.5                                    # |xyz| <= eps: invalid
    c2d = rs.rand(2, 8, 8, 2).astype(np.float32)
    im_wh = np.array([[640, 480], [320, 240]], np.float32)
    ext = rs.uniform(0.05, 0.2, (2, 3)).astype(np.float32)
    want = j_dense(*(jnp.asarray(a) for a in (mask, xyz, c2d, im_wh, ext)))
    got = dense_correspondences(*(torch.from_numpy(a) for a in (mask, xyz, c2d, im_wh, ext)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert not got[2][0, :16].any()


def test_crop_cameras_match_jax():
    rs = np.random.RandomState(2)
    K = np.tile(np.array([[500.0, 2.5, 320], [0, 505.0, 240], [0, 0, 1]], np.float32),
                (4, 1, 1))
    centers = rs.uniform(100, 400, (4, 2)).astype(np.float32)
    scales = rs.uniform(30, 300, 4).astype(np.float32)
    boxes = np.concatenate([centers - 20, centers + rs.uniform(10, 90, (4, 2))],
                           1).astype(np.float32)
    want = np.asarray(j_crop_K(jnp.asarray(K), jnp.asarray(centers),
                               jnp.asarray(scales), 64))
    got = centered_crop_K(*(torch.from_numpy(a) for a in (K, centers, scales)), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert (got[:, 0, 1] != 0).all()                     # the skew term scales too
    want = np.asarray(j_K_crop(jnp.asarray(K), jnp.asarray(boxes), (48, 32)))
    got = get_K_crop_resize(torch.from_numpy(K), torch.from_numpy(boxes), (48, 32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _dense(seeds=(0, 1, 4)):
    """Per ROI the rendered mask, normalised XYZ, 2D coords, image size,
    extent and K of a _setup scene, stacked; and the GT poses."""
    ss = [_setup(seed=s) for s in seeds]
    keys = ("mask", "xyz_norm", "coord2d", "im_wh", "extent", "K")
    return [np.stack([s[k] for s in ss]).astype(np.float32) for k in keys], \
        np.stack([s["R"] for s in ss]), np.stack([s["t"] for s in ss])


def _close_pose(got, want, tol=1e-4):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


def test_dense_ransac_matches_jax():
    args, Rg, tg = _dense()
    key = jax.random.PRNGKey(0)
    want = JE.pose_from_dense_ransac(key, *(jnp.asarray(a) for a in args), n_hyps=32)
    valid = j_dense(*(jnp.asarray(a) for a in args[:5]))[2]
    idx = jax_ransac_draw(key, valid, 32, 8)
    got = TE.pose_from_dense_ransac(*(torch.from_numpy(a) for a in args), n_hyps=32,
                                    idx=torch.from_numpy(idx))
    _close_pose(got, want)
    np.testing.assert_allclose(got[1].numpy(), tg, atol=0.01)
    g = torch.Generator().manual_seed(0)
    R, t, frac = TE.pose_from_dense_ransac(*(torch.from_numpy(a) for a in args), generator=g)
    np.testing.assert_allclose(t.numpy(), tg, atol=0.01)
    assert (frac > 0.5).all()


@pytest.mark.parametrize("seeded", [False, True])
def test_dense_uncertainty_matches_jax(seeded):
    args, Rg, tg = _dense()
    init = dict(R0=Rg @ _small_rot(), t0=tg + 0.005) if seeded else {}
    want = JE.pose_from_dense_uncertainty(*(jnp.asarray(a) for a in args),
                                          **{k: jnp.asarray(v) for k, v in init.items()})
    got = TE.pose_from_dense_uncertainty(*(torch.from_numpy(a) for a in args),
                                         **{k: torch.from_numpy(v.astype(np.float32))
                                            for k, v in init.items()})
    _close_pose(got, want)
    np.testing.assert_allclose(got[1].numpy(), tg, atol=0.01)


def _small_rot(deg=3.0):
    a = np.deg2rad(deg)
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]],
                    np.float32)


def test_dense_net_iter_matches_jax_and_guards():
    """From the net's pose 3 degrees and 5 mm off, LM lands where JAX's does.
    Guard 1: a net t 2 m off moves t by more than 1 m, so the net's t stays
    (R is still refined). Guard 2: an ROI with fewer than 4 valid points
    keeps the net's pose."""
    args, Rg, tg = _dense()
    R0 = (Rg @ _small_rot()).astype(np.float32)
    t0 = (tg + 0.005).astype(np.float32)
    t0[1, 2] += 2.0                                       # guard 1 on ROI 1
    args[0][2] = 0.0
    args[0][2, 10, 10:13] = 1.0                           # guard 2 on ROI 2: 3 points
    want = JE.pose_from_dense_net_iter(*(jnp.asarray(a) for a in args), jnp.asarray(R0),
                                       jnp.asarray(t0))
    got = TE.pose_from_dense_net_iter(*(torch.from_numpy(a) for a in args),
                                      torch.from_numpy(R0), torch.from_numpy(t0))
    _close_pose(got, want)
    R, t = got[0].numpy(), got[1].numpy()
    np.testing.assert_allclose(t[0], tg[0], atol=0.01)
    np.testing.assert_array_equal(t[1], t0[1])
    assert np.abs(R[1] - R0[1]).max() > 1e-3
    np.testing.assert_array_equal(R[2], R0[2])
    np.testing.assert_array_equal(t[2], t0[2])
