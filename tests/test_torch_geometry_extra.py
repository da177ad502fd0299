"""Port parity: the rest of ``geometry/`` against the JAX package.

``geometry/rotations.py``: ``mat_to_rot6d``, ``mat_to_quat``, ``quat_mul``,
``ego_to_allo_mat``, ``random_rotations``, the so(3) maps
(``lie_vec_to_rot``, ``rot_to_lie_vec``, ``quat_to_lie_vec``, ``qlog``,
``qexp``), ``quat_rotate_vector`` and ``quat_angular_distance``;
``geometry/camera.py``: ``project_points``, ``backproject_depth``,
``calc_xyz_from_depth`` and ``get_2d_coord_grid``. Both sides take the same
numpy inputs in fp32 on the CPU; every output is held at 1e-6 relative or
1e-5 absolute (a few fp32 operations on O(1) values; pixels at 1e-6
relative of their ~1e2 magnitude). The Lie maps keep the JAX package's safe
gradient at the identity (the oracle of ``tests/test_lie_algebra.py:27,77``):
finite, and equal to ``jax.grad``'s there and at random points.
``random_rotations`` draws from a ``torch.Generator``: the same draw gives
the same rotations, and its quaternion construction equals the JAX one on
the same normals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.geometry import camera as jcam
from gdrnpp_bop2022_tpu.geometry import rotations as jrot
from gdrnpp_bop2022_torch.geometry import camera as tcam
from gdrnpp_bop2022_torch.geometry import rotations as trot


def _close(want, got, rtol=1e-6, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _rotations(n=64, seed=0):
    """Random rotations plus the branch cases of mat_to_quat: identity,
    180 degrees about each axis (trace -1), near-180 about a diagonal."""
    rs = np.random.RandomState(seed)
    q = np.stack([np.linalg.qr(rs.randn(3, 3))[0] for _ in range(n)])
    q *= np.sign(np.linalg.det(q))[:, None, None]
    special = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
               np.diag([-1.0, -1.0, 1.0])]
    a = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = np.pi - 1e-3
    special.append(np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K)
    return np.concatenate([q, np.stack(special)]).astype(np.float32)


ROTS = _rotations()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("fn", ["mat_to_rot6d", "mat_to_quat", "rot_to_lie_vec"])
def test_matrix_maps(fn):
    _close(getattr(jrot, fn)(jnp.asarray(ROTS)), getattr(trot, fn)(_t(ROTS)))


def test_quaternion_maps():
    rs = np.random.RandomState(1)
    q1 = rs.randn(50, 4).astype(np.float32)
    q2 = rs.randn(50, 4).astype(np.float32)
    _close(jrot.quat_mul(jnp.asarray(q1), jnp.asarray(q2)), trot.quat_mul(_t(q1), _t(q2)))
    u = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    u[:3] = [[1, 0, 0, 0], [-1, 0, 0, 0], [0, 1, 0, 0]]      # identity, -identity, w = 0
    w = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    v = rs.randn(50, 3).astype(np.float32)
    for name, args in (("quat_to_lie_vec", (u,)), ("qlog", (u,)),
                       ("quat_rotate_vector", (u, v)), ("quat_angular_distance", (u, w))):
        _close(getattr(jrot, name)(*map(jnp.asarray, args)),
               getattr(trot, name)(*map(_t, args)))


def test_exp_maps_with_small_angles():
    rs = np.random.RandomState(2)
    v = rs.randn(40, 3).astype(np.float32)
    v[:10] *= 1e-5                         # the Taylor branch (|v|^2 < 1e-8)
    v[10:15] = 0.0
    v[15:20] *= 3.0                        # beyond pi
    _close(jrot.lie_vec_to_rot(jnp.asarray(v)), trot.lie_vec_to_rot(_t(v)))
    _close(jrot.qexp(jnp.asarray(v)), trot.qexp(_t(v)))


def test_ego_to_allo():
    rs = np.random.RandomState(3)
    t = np.concatenate([rs.uniform(-0.2, 0.2, (20, 2)), rs.uniform(0.5, 1.5, (20, 1))],
                       1).astype(np.float32)
    t[0] = [0.0, 0.0, 1.0]                 # on the optical axis
    R = ROTS[:20]
    got = trot.ego_to_allo_mat(_t(t), _t(R))
    _close(jrot.ego_to_allo_mat(jnp.asarray(t), jnp.asarray(R)), got)
    _close(R, trot.allo_to_ego_mat(_t(t), got))          # its inverse


def test_random_rotations_draw_from_a_generator():
    g = torch.Generator().manual_seed(7)
    R = trot.random_rotations(g, 32)
    again = trot.random_rotations(torch.Generator().manual_seed(7), 32)
    assert torch.equal(R, again) and R.dtype == torch.float32
    np.testing.assert_allclose((R.transpose(1, 2) @ R).numpy(), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
    # the construction, given the same normals
    q = torch.randn((32, 4), generator=torch.Generator().manual_seed(7))
    assert torch.equal(R, trot.quat_to_mat(trot.normalize(q)))
    _close(jrot.quat_to_mat(jrot.normalize(jnp.asarray(q.numpy()))), R)


def _grad_pairs():
    rs = np.random.RandomState(4)
    return [
        ("lie_vec_to_rot", lambda m, x: (m.lie_vec_to_rot(x)).sum(), np.zeros(3, np.float32)),
        ("lie_vec_to_rot", lambda m, x: (m.lie_vec_to_rot(x) ** 2).sum() + m.lie_vec_to_rot(x)[0, 1],
         rs.randn(3).astype(np.float32)),
        ("qexp", lambda m, x: m.qexp(x).sum(), np.zeros(3, np.float32)),
        ("qexp", lambda m, x: (m.qexp(x)[..., 0] + 2 * m.qexp(x)[..., 2]).sum(),
         rs.randn(3).astype(np.float32)),
        ("quat_to_lie_vec", lambda m, x: m.quat_to_lie_vec(x).sum(),
         np.array([1.0, 0.0, 0.0, 0.0], np.float32)),
        ("rot_to_lie_vec", lambda m, x: (m.rot_to_lie_vec(x) ** 2).sum(), np.eye(3, dtype=np.float32)),
        ("rot_to_lie_vec", lambda m, x: m.rot_to_lie_vec(x)[2], ROTS[5]),
    ]


@pytest.mark.parametrize("i", range(7))
def test_lie_gradients_match_jax(i):
    name, f, x = _grad_pairs()[i]
    want = np.asarray(jax.grad(lambda a: f(jrot, a))(jnp.asarray(x)))
    xt = _t(x.copy()).requires_grad_(True)
    (got,) = torch.autograd.grad(f(trot, xt), xt)
    assert np.all(np.isfinite(got.numpy())), name
    _close(want, got)


def test_lie_oracles():
    """tests/test_lie_algebra.py's properties, for the port."""
    R = _t(ROTS)
    np.testing.assert_allclose(trot.lie_vec_to_rot(trot.rot_to_lie_vec(R)).numpy(), ROTS,
                               atol=1e-5)
    rot = trot.lie_vec_to_rot(torch.tensor([[0.0, 0.0, np.pi / 2]]))[0].numpy()
    np.testing.assert_allclose(rot, [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-6)
    ang = trot.angular_distance(R, torch.eye(3).expand_as(R)).numpy()
    np.testing.assert_allclose(np.linalg.norm(trot.rot_to_lie_vec(R).numpy(), axis=-1)[:-5],
                               ang[:-5], atol=1e-4)
    q = trot.mat_to_quat(R[:-5])          # the random rotations: w != 0
    back = trot.qexp(trot.qlog(q))
    np.testing.assert_allclose((back * torch.sign(back[:, :1] * q[:, :1])).numpy(), q.numpy(),
                               atol=1e-5)
    assert (trot.quat_angular_distance(q, -q) < 1.5e-3).all()


def _camera_inputs(B=3, H=12, W=16, seed=5):
    rs = np.random.RandomState(seed)
    K = np.tile(np.array([[572.4, 0.5, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                (B, 1, 1))
    depth = rs.uniform(0.4, 1.6, (B, H, W)).astype(np.float32)
    depth[:, :2] = 0.0
    t = np.concatenate([rs.uniform(-0.1, 0.1, (B, 2)), rs.uniform(0.5, 1.2, (B, 1))],
                       1).astype(np.float32)
    pts = rs.uniform(-0.1, 0.1, (B, 30, 3)).astype(np.float32)
    return K, ROTS[:B], t, depth, pts


def test_camera_functions():
    K, R, t, depth, pts = _camera_inputs()
    j = lambda *a: map(jnp.asarray, a)        # noqa: E731
    _close(jcam.project_points(*j(pts, K, R, t)), tcam.project_points(*map(_t, (pts, K, R, t))))
    _close(jcam.backproject_depth(*j(depth, K)), tcam.backproject_depth(_t(depth), _t(K)))
    got = tcam.calc_xyz_from_depth(*map(_t, (depth, K, R, t)))
    _close(jcam.calc_xyz_from_depth(*j(depth, K, R, t)), got)
    assert (got[:, :2] == 0).all()


@pytest.mark.parametrize("args", [(16, 12, 0.0, 1.0, "HWC"), (7, 5, -1.0, 1.0, "CHW"),
                                  (64, 64, 0.0, 1.0, "HWC"), (1, 3, 0.25, 2.0, "CHW")])
def test_coord_grid(args):
    w, h, lo, hi, fmt = args
    want = jcam.get_2d_coord_grid(w, h, lo, hi, fmt)
    got = tcam.get_2d_coord_grid(w, h, lo, hi, fmt)
    assert got.shape == want.shape
    _close(want, got)
