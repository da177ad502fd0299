"""Port parity: BOP pose-error metrics against the JAX package.

Every batched metric of ``eval/pose_error.py`` and its single-instance
wrapper runs on the same numpy-drawn poses, points, cameras and symmetry
banks through both packages; they agree within 1e-5 relative, plus an
absolute floor of a few fp32 ulps of the quantities that cancel: 1e-6 m for
metric distances of points ~1 m from the camera, 2.5e-4 px (4 ulps at
640 px) for projection distances. The estimates are 10-40 degrees off the
GT: re is arccos of the trace, which turns one ulp of the trace into
ulp / sin(angle) rad, and a small-angle case is held to that bound. ADD-S is
also held equal to itself with its GT points split into blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.eval import pose_error as J
from gdrnpp_bop2022_torch.eval import pose_error as T

RTOL, ATOL = 1e-5, 1e-6
ATOL_PX = 4 * 2.0 ** -14        # 4 ulps of a pixel coordinate in [512, 1024)


def _rot(rs, n):
    q, _ = np.linalg.qr(rs.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _axis_angle(rs, n, deg_lo, deg_hi):
    """n rotations about random axes by angles in [deg_lo, deg_hi] degrees."""
    k = rs.randn(n, 3)
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    th = np.deg2rad(rs.uniform(deg_lo, deg_hi, n))[:, None, None]
    Km = np.zeros((n, 3, 3))
    Km[:, 0, 1], Km[:, 0, 2], Km[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    Km = Km - Km.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * Km + (1 - np.cos(th)) * Km @ Km


def _case(seed=0, B=5, N=40, S=3, deg=(10.0, 40.0)):
    rs = np.random.RandomState(seed)
    Rg = _rot(rs, B)
    tg = np.stack([rs.uniform(-0.1, 0.1, B), rs.uniform(-0.1, 0.1, B),
                   rs.uniform(0.5, 1.0, B)], 1).astype(np.float32)
    Re = Rg @ _axis_angle(rs, B, *deg)
    te = tg + rs.randn(B, 3).astype(np.float32) * 0.01
    pts = rs.uniform(-0.05, 0.05, (B, N, 3)).astype(np.float32)
    K = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
                (B, 1, 1))
    sR = _rot(rs, B * S).reshape(B, S, 3, 3)
    sR[:, 0] = np.eye(3)
    st = (rs.randn(B, S, 3) * 0.01).astype(np.float32)
    st[:, 0] = 0
    sv = rs.rand(B, S) > 0.4
    sv[:, 0] = True
    return dict(Re=Re.astype(np.float32), te=te, Rg=Rg, tg=tg, pts=pts, K=K, sR=sR, st=st,
                sv=sv)


_METRICS = {
    "add": (("Re", "te", "Rg", "tg", "pts"), "add_batch"),
    "adi": (("Re", "te", "Rg", "tg", "pts"), "adi_batch"),
    "re": (("Re", "Rg"), "re_batch"),
    "te": (("te", "tg"), "te_batch"),
    "proj": (("Re", "te", "Rg", "tg", "K", "pts"), "proj_batch"),
    "mssd": (("Re", "te", "Rg", "tg", "pts", "sR", "st", "sv"), "mssd_batch"),
    "mspd": (("Re", "te", "Rg", "tg", "K", "pts", "sR", "st", "sv"), "mspd_batch"),
}


def _atol(name):
    return ATOL_PX if name in ("proj", "mspd") else ATOL


@pytest.mark.parametrize("name", sorted(_METRICS))
def test_batch_metric_matches_jax(name):
    keys, fn = _METRICS[name]
    c = _case(seed=len(name))
    want = np.asarray(getattr(J, fn)(*(jnp.asarray(c[k]) for k in keys)))
    got = getattr(T, fn)(*(torch.from_numpy(c[k]) for k in keys))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=_atol(name))


def test_re_small_angles_within_trace_ulp():
    """At 0.5-3 degrees one ulp of the fp32 trace moves re by about
    2^-23 / sin(angle) rad: the two packages sum the trace in another order."""
    c = _case(seed=11, B=64, deg=(0.5, 3.0))
    want = np.asarray(J.re_batch(jnp.asarray(c["Re"]), jnp.asarray(c["Rg"])))
    got = T.re_batch(torch.from_numpy(c["Re"]), torch.from_numpy(c["Rg"])).numpy()
    bound = np.rad2deg(4 * 2.0 ** -23 / np.sin(np.deg2rad(want)))
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want) / bound


def test_adi_blocks_equal_one_pass():
    c = _case(seed=3, N=64)
    args = [torch.from_numpy(c[k]) for k in ("Re", "te", "Rg", "tg", "pts")]
    one = T.adi_batch(*args)
    for block in (1, 5 * 7, 5 * 64 * 64):     # 1 GT point per block .. all at once
        np.testing.assert_allclose(T.adi_batch(*args, max_block=block).numpy(), one.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_mssd_picks_the_symmetry_that_fits():
    """An estimate equal to the GT composed with a valid symmetry scores ~0;
    the same symmetry marked invalid does not."""
    c = _case(seed=4, B=2, S=2)
    Re = c["Rg"] @ c["sR"][:, 1]
    te = np.einsum("bij,bj->bi", c["Rg"], c["st"][:, 1]) + c["tg"]
    sv = np.ones((2, 2), bool)
    args = lambda v: [torch.from_numpy(np.asarray(a, np.float32)) for a in  # noqa: E731
                      (Re, te, c["Rg"], c["tg"], c["pts"], c["sR"], c["st"])] + \
        [torch.from_numpy(v)]
    assert float(T.mssd_batch(*args(sv)).max()) < 1e-5
    sv[:, 1] = False
    assert float(T.mssd_batch(*args(sv)).min()) > 1e-3


def test_cou_mask_matches_jax():
    rs = np.random.RandomState(5)
    a, b = rs.rand(3, 9, 11) > 0.5, rs.rand(3, 9, 11) > 0.3
    b[2] = a[2] = False                       # empty union -> 0 by the max(union, 1)
    want = np.asarray(J.cou_mask(jnp.asarray(a), jnp.asarray(b)))
    got = T.cou_mask(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["add", "adi", "re", "te", "proj", "mssd", "mspd"])
def test_single_instance_wrapper_matches_jax(name):
    c = _case(seed=6, B=1, S=2)
    one = {k: v[0] for k, v in c.items()}
    syms = [{"R": one["sR"][i], "t": one["st"][i]} for i in range(2)]
    args = {"add": ("Re", "te", "Rg", "tg", "pts"), "adi": ("Re", "te", "Rg", "tg", "pts"),
            "re": ("Re", "Rg"), "te": ("te", "tg"),
            "proj": ("Re", "te", "Rg", "tg", "K", "pts"),
            "mssd": ("Re", "te", "Rg", "tg", "pts"),
            "mspd": ("Re", "te", "Rg", "tg", "K", "pts")}[name]
    extra = (syms,) if name in ("mssd", "mspd") else ()
    want = getattr(J, name)(*(one[k] for k in args), *extra)
    got = getattr(T, name)(*(one[k] for k in args), *extra, device="cpu")
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(name))


def test_sym_bank_np_matches_jax():
    rs = np.random.RandomState(7)
    for syms in ([], [{"R": _rot(rs, 1)[0], "t": rs.randn(3)} for _ in range(3)]):
        for a, b in zip(J._sym_bank_np(syms), T._sym_bank_np(syms)):
            np.testing.assert_array_equal(np.asarray(a), b)
