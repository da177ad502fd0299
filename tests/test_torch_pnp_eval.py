"""Port parity: depth refinement, dense correspondences and crop cameras.

``depth_refine_batch`` runs on the ``_setup`` scenes of tests/test_pnp_eval.py
(a cube rendered at its GT pose, the translation pushed off by a few cm)
through the JAX package and the port (plain rasterizer on the CPU); the
refined translations agree within 1e-5 m, and the port keeps the property
that test asserts: a 4 cm z error falls below 30% of itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.eval.pnp_eval import dense_correspondences as j_dense
from gdrnpp_bop2022_tpu.eval.pnp_eval import depth_refine_batch as j_refine
from gdrnpp_bop2022_tpu.geometry.camera import centered_crop_K as j_crop_K
from gdrnpp_bop2022_tpu.geometry.camera import get_K_crop_resize as j_K_crop
from gdrnpp_bop2022_torch.eval.pnp_eval import dense_correspondences, depth_refine_batch
from gdrnpp_bop2022_torch.geometry.camera import centered_crop_K, get_K_crop_resize
from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda
from test_pnp_eval import _setup

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
