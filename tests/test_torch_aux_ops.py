"""Port parity: the auxiliary ops against the JAX package.

``ops/fps.py``, ``ops/chamfer.py``, ``ops/flow.py``, ``ops/edges.py`` and
``ops/ransac_voting.py`` (the JAX package's plain-jnp counterparts of the
reference's native extensions core/csrc/{fps,torch_nndistance,flow,
ransac_voting} and core/utils/edge_utils.py), fp32 on the CPU on the same
numpy inputs:

  * fps: indices exact (``torch.argmax`` and ``jnp.argmax`` both take the
    first of equal maxima);
  * chamfer: distances to 1e-5 of max(|d|, the largest squared norm): d is
    |a|^2 + |b|^2 - 2 a.b, so it rounds at the scale of the squared norms,
    not of d; indices exact, or where they differ, distances equal to that
    tolerance (a tie); a fully masked row gives index 0 as ``jnp.argmin``;
  * flow: to 1e-4 px;
  * canny: the edge maps equal except at pixels within 1e-4 of a decision
    boundary (the threshold, a direction bin's edge, or a tie with a
    neighbour's magnitude), recomputed in float64;
  * ransac voting: given the JAX draws (``jax.random.categorical`` under the
    JAX key splits), point, inlier fraction, mean and covariance to 1e-3 px
    (px^2 for the covariance);
  * the oracles of ``tests/test_aux_ops.py:14-44,84-122`` for the port.
Each JAX function is traced at most once per shape here.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops import chamfer as jch
from gdrnpp_bop2022_tpu.ops import edges as jed
from gdrnpp_bop2022_tpu.ops import flow as jfl
from gdrnpp_bop2022_tpu.ops import fps as jfps
from gdrnpp_bop2022_tpu.ops import ransac_voting as jrv
from gdrnpp_bop2022_torch.ops import chamfer as tch
from gdrnpp_bop2022_torch.ops import edges as ted
from gdrnpp_bop2022_torch.ops import flow as tfl
from gdrnpp_bop2022_torch.ops import fps as tfps
from gdrnpp_bop2022_torch.ops import ransac_voting as trv

K_CAM = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("init_center", [False, True])
def test_fps_indices_exact(init_center):
    rs = np.random.RandomState(0)
    pts = rs.uniform(-0.1, 0.1, (600, 3)).astype(np.float32)
    pts[100:110] = pts[5]                   # duplicates: the first one is picked
    want = np.asarray(jfps.fps_indices(jnp.asarray(pts), 40, init_center))
    got = tfps.fps_indices(torch.from_numpy(pts), 40, init_center)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfps.farthest_point_sampling(torch.from_numpy(pts), 40, init_center).numpy(),
        np.asarray(jfps.farthest_point_sampling(jnp.asarray(pts), 40, init_center)))


def _chamfer_check(want, got, scale):
    dw1, iw1, dw2, iw2 = (np.asarray(a) for a in want)
    dg1, ig1, dg2, ig2 = (a.numpy() for a in got)
    for dw, iw, dg, ig in ((dw1, iw1, dg1, ig1), (dw2, iw2, dg2, ig2)):
        tol = 1e-5 * np.maximum(np.abs(dw), scale)
        with np.errstate(invalid="ignore"):                  # inf - inf
            same = (dg == dw) | (np.abs(dg - dw) <= tol)    # == holds inf == inf
        assert same.all()
        assert ((ig == iw) | same).all()


@pytest.mark.parametrize("masks", ["none", "mask1", "mask2", "both"])
def test_chamfer(masks):
    rs = np.random.RandomState(1)
    a = rs.uniform(-0.1, 0.1, (3, 200, 3)).astype(np.float32)
    b = rs.uniform(-0.1, 0.1, (3, 150, 3)).astype(np.float32)
    m1 = rs.rand(3, 200) > 0.2 if masks in ("mask1", "both") else None
    m2 = rs.rand(3, 150) > 0.2 if masks in ("mask2", "both") else None
    if m2 is not None:
        m2[2] = False                       # every candidate masked: index 0
    j = [None if v is None else jnp.asarray(v) for v in (m1, m2)]
    t = [None if v is None else torch.from_numpy(v) for v in (m1, m2)]
    want = jch.chamfer_distance(jnp.asarray(a), jnp.asarray(b), *j)
    got = tch.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b), *t)
    scale = max((a ** 2).sum(-1).max(), (b ** 2).sum(-1).max())
    _chamfer_check(want, got, scale)
    if m2 is not None and m1 is None:
        assert (got[1][2] == 0).all() and np.isinf(got[0][2].numpy()).all()


def _flow_inputs(B=2, H=20, W=24, seed=2):
    rs = np.random.RandomState(seed)
    depth = rs.uniform(0.5, 1.5, (B, H, W)).astype(np.float32)
    depth[:, :3] = 0.0
    R = np.stack([np.linalg.qr(np.eye(3) + 0.05 * rs.randn(3, 3))[0] for _ in range(B)])
    R *= np.sign(np.linalg.det(R))[:, None, None]
    t = rs.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    return depth, np.tile(K, (B, 1, 1)), R.astype(np.float32), t


def test_flow_matches_jax():
    args = _flow_inputs()
    fw, vw = jfl.flow_from_depth(*map(jnp.asarray, args))
    fg, vg = tfl.flow_from_depth(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(vw))
    np.testing.assert_allclose(fg.numpy(), np.asarray(fw), rtol=0, atol=1e-4)


def test_flow_pure_translation():
    K = np.array([[100.0, 0, 8.0], [0, 100.0, 8.0], [0, 0, 1]], np.float32)[None]
    flow, valid = tfl.flow_from_depth(torch.full((1, 16, 16), 2.0), torch.from_numpy(K),
                                      torch.eye(3)[None], torch.tensor([[0.1, 0.0, 0.0]]))
    np.testing.assert_allclose(flow[0, ..., 0].numpy(), 5.0, atol=1e-4)
    np.testing.assert_allclose(flow[0, ..., 1].numpy(), 0.0, atol=1e-4)
    assert valid.all()


def canny_near(images, thr, margin=1e-4):
    """Pixels whose canny_edges decision is within ``margin`` of a boundary,
    recomputed in float64."""
    img = torch.from_numpy(np.asarray(images, np.float64))
    img = img.mean(dim=-1) if img.dim() == 4 else img
    gx, gy = ted.sobel_gradients(ted.sep_blur(img, ted.gauss_kernel()))
    mag = torch.sqrt(gx * gx + gy * gy)
    a = torch.atan2(gy, gx) / (math.pi / 4)
    near = ((mag - thr).abs() <= margin * max(thr, 1.0)) | (((a - a.floor()) - 0.5).abs() <= margin)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                near |= (mag - ted.shift(mag, dy, dx)).abs() <= margin * mag.clamp_min(1.0)
    return near.numpy()


@pytest.mark.parametrize("rgb", [False, True])
def test_canny_matches_jax(rgb):
    rs = np.random.RandomState(3)
    shape = (2, 40, 56, 3) if rgb else (2, 40, 56)
    yy, xx = np.mgrid[0:40, 0:56]
    img = np.zeros(shape, np.float32)
    for i in range(2):
        for _ in range(5):
            cy, cx, r = rs.uniform(0, 40), rs.uniform(0, 56), rs.uniform(4, 15)
            img[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rs.uniform(0, 255, shape[3:] or ())
    img += rs.normal(0, 4, shape).astype(np.float32)
    want = np.asarray(jed.canny_edges(jnp.asarray(img), 10.0))
    got = ted.canny_edges(torch.from_numpy(img), 10.0).numpy()
    diff = got != want
    assert want.sum() > 50
    assert not (diff & ~canny_near(img, 10.0)).any(), int(diff.sum())


def test_sobel_and_blur_match_jax():
    img = np.random.RandomState(4).uniform(0, 255, (2, 17, 23)).astype(np.float32)
    for w, g in zip(jed.sobel_gradients(jnp.asarray(img)), ted.sobel_gradients(torch.from_numpy(img))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(
        ted.sep_blur(torch.from_numpy(img), ted.gauss_kernel()).numpy(),
        np.asarray(jed._sep_blur(jnp.asarray(img), jed._gauss_kernel())), rtol=1e-6, atol=1e-4)


def test_canny_oracles():
    """tests/test_aux_ops.py::test_canny_edges_square and
    ::test_canny_agrees_with_cv2_on_boundary, for the port."""
    img = np.zeros((1, 48, 64), np.float32)
    img[:, 12:36, 20:52] = 200.0
    edges = ted.canny_edges(torch.from_numpy(img), 20.0).numpy()[0]
    assert edges[10:14, 30].any() and edges[34:38, 30].any()
    assert edges[24, 18:22].any() and edges[24, 50:54].any()
    assert not edges[20:30, 30:44].any() and not edges[2:6, 2:10].any()
    assert edges[8:40, 30].sum() <= 6
    rs = np.random.RandomState(0)
    img = np.zeros((64, 64), np.float32)
    cv2.circle(img, (32, 32), 18, 220.0, -1)
    img += rs.randn(64, 64).astype(np.float32) * 2
    mine = ted.canny_edges(torch.from_numpy(img)[None], 30.0).numpy()[0]
    ref = cv2.Canny(img.astype(np.uint8), 60, 120) > 0
    dil = cv2.dilate(ref.astype(np.uint8), np.ones((5, 5), np.uint8)) > 0
    assert (mine & dil).sum() / max(mine.sum(), 1) > 0.9


def _vote_fields(B=2, H=32, W=32, K=2, seed=5):
    rs = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    coords = np.stack([xs, ys], -1)
    mask = np.zeros((B, H, W), np.float32)
    vertex = np.zeros((B, H, W, K, 2), np.float32)
    kps = rs.uniform(6, 26, (B, K, 2)).astype(np.float32)
    for i in range(B):
        mask[i, 3:29, 4:28] = 1.0
        for k in range(K):
            d = kps[i, k] - coords + rs.normal(0, 0.3, coords.shape).astype(np.float32)
            vertex[i, :, :, k] = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    return mask, vertex, kps


def _jax_draws(key, mask, K, n_hyps):
    """The pixels ransac_voting_layer draws under `key`: (B, K, n) twice."""
    idx1, idx2 = [], []
    for kb, m in zip(jax.random.split(key, mask.shape[0]), mask):
        logits = jnp.where(jnp.asarray(m.reshape(-1) > 0.5), 0.0, -1e9)
        row1, row2 = [], []
        for kk in jax.random.split(kb, K):
            k1, k2 = jax.random.split(kk)
            row1.append(np.asarray(jax.random.categorical(k1, logits, shape=(n_hyps,))))
            row2.append(np.asarray(jax.random.categorical(k2, logits, shape=(n_hyps,))))
        idx1.append(row1)
        idx2.append(row2)
    return np.asarray(idx1), np.asarray(idx2)


def test_ransac_voting_layer_given_the_jax_draws():
    mask, vertex, kps = _vote_fields()
    key = jax.random.PRNGKey(0)
    want = np.asarray(jrv.ransac_voting_layer(key, jnp.asarray(mask), jnp.asarray(vertex),
                                              n_hyps=64))
    idx1, idx2 = _jax_draws(key, mask, 2, 64)
    got = trv.ransac_voting_layer(torch.from_numpy(mask), torch.from_numpy(vertex), 64,
                                  idx1=torch.from_numpy(idx1), idx2=torch.from_numpy(idx2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    assert np.abs(got.numpy() - kps).max() < 1.0


def test_ransac_voting_keypoint_given_the_jax_draws():
    mask, vertex, _ = _vote_fields(B=1, K=1, seed=6)
    H, W = mask.shape[1:]
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    coords = np.stack([xs, ys], -1).reshape(-1, 2)
    d = vertex[0, :, :, 0].reshape(-1, 2)
    m = mask[0].reshape(-1) > 0.5
    key = jax.random.PRNGKey(3)
    want = jrv.ransac_voting_keypoint(key, jnp.asarray(coords), jnp.asarray(d), jnp.asarray(m),
                                      n_hyps=32)
    k1, k2 = jax.random.split(key)
    logits = jnp.where(jnp.asarray(m), 0.0, -1e9)
    i1, i2 = (torch.from_numpy(np.array(jax.random.categorical(k, logits, shape=(32,))))
              for k in (k1, k2))
    got = trv.ransac_voting_keypoint(torch.from_numpy(coords), torch.from_numpy(d),
                                     torch.from_numpy(m), 32, idx1=i1, idx2=i2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)


def test_ransac_voting_finds_keypoint_with_a_generator():
    """tests/test_aux_ops.py::test_ransac_voting_finds_keypoint, drawing
    with a torch.Generator; an empty mask draws over every pixel."""
    H = W = 32
    kp = np.array([20.0, 12.0], np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    d = kp[None, None] - np.stack([xs, ys], -1)
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
    mask = np.zeros((H, W), np.float32)
    mask[4:28, 4:28] = 1.0
    g = torch.Generator().manual_seed(0)
    out = trv.ransac_voting_layer(torch.from_numpy(mask)[None], torch.from_numpy(d[:, :, None])[None],
                                  64, generator=g)
    assert np.linalg.norm(out.numpy()[0, 0] - kp) < 0.5
    draws = trv.draw_pixels(torch.zeros(H * W, dtype=torch.bool), 500, g)
    assert draws.min() >= 0 and draws.max() < H * W and len(set(draws.tolist())) > 300
