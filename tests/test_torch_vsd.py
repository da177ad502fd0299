"""Port parity: VSD (``eval/vsd.py``) against the JAX package.

The cube scenes of tests/test_vsd_full.py go through both packages, the
port's renders through the plain rasterizer on the CPU. Per pair and tau
the errors agree within one pixel's share of the pair's union (1 / union
count, the most a render differing at one seam pixel can move them):
the full-image path, the image-grid bbox path (which also equals the
port's full path within the same share) and the resampled window (whose
union is on the window grid, so it is held to 1e-6). The host planners
(``vsd_bbox_plan``, ``window_fits``) agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.eval import vsd as JV
from gdrnpp_bop2022_torch.eval import vsd as TV
from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
from test_vsd_full import H, K, TAUS, W, _cube, _literal_vsd

DELTA = 0.015


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _union_count(d_test, d_est, d_gt, Kc):
    """The BOP19 visibility union of one pair on one pixel grid (numpy)."""
    h, w = d_test.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    ray = np.sqrt(((us - Kc[0, 2]) / Kc[0, 0]) ** 2 + ((vs - Kc[1, 2]) / Kc[1, 1]) ** 2 + 1)
    dt, de, dg = d_test * ray, d_est * ray, d_gt * ray
    vg = ((dg - dt <= DELTA) | (dt == 0)) & (dg > 0)
    ve = ((de - dt <= DELTA) | (dt == 0)) & (de > 0)
    return int((vg | ve | (vg & (de > 0))).sum())


def _render(verts, faces, R, t, Kc, h, w):
    d, _ = render_depth_xyz_batch(_t(verts)[None], _t(faces)[None], _t(R)[None], _t(t)[None],
                                  _t(Kc)[None], h, w, need_xyz=False)
    return d[0].numpy()


def _assert_pixel_share(got, want, unions):
    share = 1.0 / np.maximum(np.asarray(unions, np.float64), 1)[:, None]
    assert (np.abs(got - want) <= share + 1e-7).all(), (got, want, share)


def _full_cases():
    """tests/test_vsd_full.py::test_full_vsd_matches_literal_port's scenes:
    a rotated cube, the estimate 0.2 rad and ~1 cm off, an occluding strip."""
    verts, faces = _cube()
    rs = np.random.RandomState(0)
    cases = []
    for _ in range(3):
        ang = rs.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        R_gt = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t_gt = np.array([0.01, -0.01, 0.5], np.float32)
        R_est = R_gt @ np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                                 [0, np.sin(0.2), np.cos(0.2)]], np.float32)
        t_est = t_gt + rs.randn(3).astype(np.float32) * 0.01
        d_test = _render(verts, faces, R_gt, t_gt, K, H, W)
        d_test[:, 60:80] = np.where(d_test[:, 60:80] > 0, 0.3, 0.0)
        cases.append((R_est, t_est, R_gt, t_gt, d_test))
    return verts, faces, cases


def _stack(verts, faces, cases, Kc):
    B = len(cases)
    diam = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    return [np.stack([c[i] for c in cases]) for i in range(5)] + [
        np.tile(Kc, (B, 1, 1)), np.tile(verts[None], (B, 1, 1)), np.tile(faces[None], (B, 1, 1)),
        np.full(B, diam, np.float32), TAUS]


def test_depth_to_dist_matches_jax():
    rs = np.random.RandomState(1)
    d = rs.uniform(0, 2, (2, 7, 9)).astype(np.float32)
    Ks = np.stack([K, K * np.array([[1.1], [0.9], [1]], np.float32)])
    want = np.asarray(JV.depth_to_dist(jnp.asarray(d), jnp.asarray(Ks)))
    np.testing.assert_allclose(TV.depth_to_dist(_t(d), _t(Ks)).numpy(), want, rtol=1e-6)


def test_full_vsd_matches_jax_and_literal():
    verts, faces, cases = _full_cases()
    args = _stack(verts, faces, cases, K)
    want = np.asarray(JV.vsd_batch_full(*(jnp.asarray(a) for a in args), DELTA))
    got = TV.vsd_batch_full(*(_t(a) for a in args), DELTA).numpy()
    assert got.shape == (3, len(TAUS))
    unions, literal = [], []
    diam = float(args[8][0])
    for R_est, t_est, R_gt, t_gt, d_test in cases:
        d_est = _render(verts, faces, R_est, t_est, K, H, W)
        d_gt = _render(verts, faces, R_gt, t_gt, K, H, W)
        unions.append(_union_count(d_test, d_est, d_gt, K))
        literal.append(_literal_vsd(d_test, d_est, d_gt, diam, TAUS, DELTA))
    _assert_pixel_share(got, want, unions)
    np.testing.assert_allclose(got, np.stack(literal), atol=1e-6)
    assert (got < 1).any() and np.isclose(got, 1).any()     # a near and a missing pair


def test_window_vsd_matches_jax():
    """tests/test_vsd_full.py::test_window_close_to_full_when_fits's scenes."""
    verts, faces = _cube()
    rs = np.random.RandomState(1)
    cases = []
    for _ in range(5):
        R = np.eye(3, dtype=np.float32)
        t_gt = np.array([rs.uniform(-0.05, 0.05), rs.uniform(-0.03, 0.03), 0.5], np.float32)
        t_est = t_gt + rs.randn(3).astype(np.float32) * 0.005
        cases.append((R, t_est, R, t_gt, _render(verts, faces, R, t_gt, K, H, W)))
    args = _stack(verts, faces, cases, K)
    for res in (64, 128):
        want = np.asarray(JV.vsd_batch(*(jnp.asarray(a) for a in args), DELTA, res=res))
        got = TV.vsd_batch(*(_t(a) for a in args), DELTA, res=res).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


def _bbox_cases():
    """tests/test_vsd_full.py::test_bbox_vsd_matches_full's scenes on a
    240x320 image: in-frame pairs, one partly out of the frame, a separated
    pair in one bucket. Returns the stacked arguments and the plan."""
    H2, W2 = 240, 320
    K2 = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]], np.float32)
    verts, faces = _cube()
    radius = float(np.linalg.norm(verts, axis=-1).max())
    rs = np.random.RandomState(5)
    I3 = np.eye(3, dtype=np.float32)
    poses = []
    for _ in range(3):
        t_gt = np.array([rs.uniform(-0.08, 0.08), rs.uniform(-0.05, 0.05),
                         rs.uniform(0.4, 0.7)], np.float32)
        poses.append((t_gt + rs.randn(3).astype(np.float32) * 0.01, t_gt))
    poses.append((np.array([-0.155, 0, 0.3], np.float32), np.array([-0.16, 0, 0.3], np.float32)))
    poses.append((np.array([0.06, 0.02, 0.5], np.float32), np.array([0, 0, 0.5], np.float32)))
    cases = []
    for t_est, t_gt in poses:
        d_test = _render(verts, faces, I3, t_gt, K2, H2, W2)
        d_test[:, 140:170] = np.where(d_test[:, 140:170] > 0, 0.25, 0.0)
        cases.append((I3, t_est, I3, t_gt, d_test))
    args = _stack(verts, faces, cases, K2)
    unions = [_union_count(c[4], _render(verts, faces, I3, c[1], K2, H2, W2),
                           _render(verts, faces, I3, c[3], K2, H2, W2), K2) for c in cases]
    plan = TV.vsd_bbox_plan(args[1], args[3], args[5], np.full(len(cases), radius), H2, W2)
    return args, unions, plan


def _windows(args, plan, bi):
    """The pairs of bucket bi with their image-grid test-depth windows."""
    bucket, offs, buckets = plan
    (bh, bw), m = buckets[bi], np.where(bucket == bi)[0]
    wins = np.stack([args[4][i, offs[i, 0]:offs[i, 0] + bh, offs[i, 1]:offs[i, 1] + bw]
                     for i in m])
    return m, [a[m] for a in args[:4]] + [wins, offs[m], args[5][m]] + \
        [a[m] for a in args[6:9]] + [TAUS]


def test_bbox_vsd_matches_jax_and_full():
    args, unions, plan = _bbox_cases()
    full = TV.vsd_batch_full(*(_t(a) for a in args), DELTA).numpy()
    assert (plan[0] >= 0).all() and len(set(plan[0].tolist())) == 2
    for bi in range(len(plan[2])):
        m, sub = _windows(args, plan, bi)
        if not len(m):
            continue
        want = np.asarray(JV.vsd_batch_bbox(*(jnp.asarray(a) for a in sub), DELTA))
        got = TV.vsd_batch_bbox(*(_t(a) for a in sub), DELTA).numpy()
        _assert_pixel_share(got, want, [unions[i] for i in m])
        _assert_pixel_share(got, full[m], [unions[i] for i in m])


def test_host_planners_match_jax():
    rs = np.random.RandomState(2)
    B = 200
    Ks = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                 (B, 1, 1))
    tg = np.stack([rs.uniform(-0.3, 0.3, B), rs.uniform(-0.2, 0.2, B),
                   rs.uniform(0.05, 1.5, B)], 1).astype(np.float32)
    te = tg + rs.randn(B, 3).astype(np.float32) * rs.choice([0.005, 0.05, 0.3], (B, 1))
    radii = rs.uniform(0.02, 0.15, B)
    for sizes in ((128, 256, 512), (64, 640)):
        want = JV.vsd_bbox_plan(te, tg, Ks, radii, 480, 640, sizes=sizes)
        got = TV.vsd_bbox_plan(te, tg, Ks, radii, 480, 640, sizes=sizes)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    assert (got[0] == -1).any() and (got[0] >= 0).any()
    R = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    for res in (64, 128):
        want = JV.window_fits(R, te, R, tg, Ks, 2 * radii, 480, 640, res=res)
        got = TV.window_fits(R, te, R, tg, Ks, 2 * radii, 480, 640, res=res)
        np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_dispatch_modes():
    """auto = full where the window would clip (the far-off estimate of
    tests/test_vsd_full.py::test_dispatch_falls_back_when_window_clips),
    window and full run their paths, each render depth-only through
    ``render``."""
    verts, faces = _cube()
    R = np.eye(3, dtype=np.float32)
    t_gt = np.array([-0.15, 0.0, 0.35], np.float32)
    t_est = np.array([0.18, 0.05, 0.35], np.float32)
    case = (R, t_est, R, t_gt, _render(verts, faces, R, t_gt, K, H, W))
    args = [_t(a) for a in _stack(verts, faces, [case], K)]
    calls = []

    def counting(*a, need_xyz=True):
        calls.append(need_xyz)
        return render_depth_xyz_batch(*a, need_xyz=need_xyz)

    full = TV.vsd_batch_full(*args, DELTA)
    assert not TV.window_fits(*(a.numpy() for a in args[:4]), args[5].numpy(),
                              args[8].numpy(), H, W).all()
    auto = TV.vsd_dispatch(*args, DELTA, mode="auto", render=counting)
    torch.testing.assert_close(auto, full, rtol=0, atol=0)
    assert float(full.min()) > 0.9
    win = TV.vsd_dispatch(*args, DELTA, mode="window", render=counting)
    torch.testing.assert_close(win, TV.vsd_batch(*args, DELTA), rtol=0, atol=0)
    assert calls == [False] * 4
    with pytest.raises(ValueError, match="auto"):
        TV.vsd_dispatch(*args, DELTA, mode="bbox")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B2")
    return torch.device("cuda")


@pytest.mark.gpu
def test_vsd_through_b2_equals_plain_on_the_card():
    """The full image and the image-grid windows (principal point shifted by
    the window origin): VSD through B2 equals VSD through the plain
    rasterizer on the card."""
    dev = _cuda_or_skip()
    plain = lambda *a, need_xyz=True: render_depth_xyz_batch(*a, need_xyz=need_xyz)  # noqa: E731
    args, _, plan = _bbox_cases()
    on = [_t(a).to(dev) for a in args]
    torch.testing.assert_close(TV.vsd_batch_full(*on, DELTA),
                               TV.vsd_batch_full(*on, DELTA, render=plain), rtol=0, atol=0)
    for bi in range(len(plan[2])):
        m, sub = _windows(args, plan, bi)
        on = [_t(a).to(dev) for a in sub]
        torch.testing.assert_close(TV.vsd_batch_bbox(*on, DELTA),
                                   TV.vsd_batch_bbox(*on, DELTA, render=plain), rtol=0, atol=0)
