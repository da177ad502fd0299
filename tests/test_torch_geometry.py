"""Port parity: geometry (rotations, SITE decode) against the JAX package.

Both sides run in fp32 on the CPU on the same numpy inputs. Tolerance
1e-5 absolute: the functions are a few fp32 operations deep on O(1)
values, so any larger gap is a different formula, not rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.geometry import rotations as jrot
from gdrnpp_bop2022_tpu.geometry import se3 as jse3
from gdrnpp_bop2022_torch.geometry import rotations as trot
from gdrnpp_bop2022_torch.geometry import se3 as tse3

TOL = 1e-5


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


def _site_inputs(B=7, seed=0):
    rs = np.random.RandomState(seed)
    K = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    return {
        "rot_allo": np.array(jrot.rot6d_to_mat(
            jnp.asarray(rs.randn(B, 6).astype(np.float32)))),
        "centroid_rel": (0.3 * rs.randn(B, 2)).astype(np.float32),
        "z_rel": rs.uniform(0.2, 2.0, B).astype(np.float32),
        "roi_cams": K,
        "roi_centers": rs.uniform(50, 600, (B, 2)).astype(np.float32),
        "resize_ratios": rs.uniform(0.2, 1.5, B).astype(np.float32),
        "roi_whs": rs.uniform(20, 200, (B, 2)).astype(np.float32),
    }


@pytest.mark.parametrize("fn", ["normalize", "rot6d_to_mat"])
def test_rot6d(fn):
    x = np.random.RandomState(1).randn(11, 6).astype(np.float32)
    _close(getattr(jrot, fn)(jnp.asarray(x)), getattr(trot, fn)(torch.from_numpy(x)))


def test_quat_and_axangle():
    rs = np.random.RandomState(2)
    q = rs.randn(9, 4).astype(np.float32) * 2.0        # non-unit on purpose
    _close(jrot.quat_to_mat(jnp.asarray(q)), trot.quat_to_mat(torch.from_numpy(q)))
    axis = rs.randn(9, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rs.uniform(-3, 3, 9).astype(np.float32)
    _close(jrot.axangle_to_quat(jnp.asarray(axis), jnp.asarray(ang)),
           trot.axangle_to_quat(torch.from_numpy(axis), torch.from_numpy(ang)))


@pytest.mark.parametrize("case", ["random", "on_axis"])
def test_allo_to_ego(case):
    rs = np.random.RandomState(3)
    t = rs.randn(8, 3).astype(np.float32) * 0.2 + np.array([0, 0, 1.0], np.float32)
    if case == "on_axis":  # the object ray is the optical axis: eps guards
        t[:, :2] = 0.0
    R = np.array(jrot.rot6d_to_mat(jnp.asarray(rs.randn(8, 6).astype(np.float32))))
    _close(jrot.allo_to_ego_quat_correction(jnp.asarray(t)),
           trot.allo_to_ego_quat_correction(torch.from_numpy(t)))
    _close(jrot.allo_to_ego_mat(jnp.asarray(t), jnp.asarray(R)),
           trot.allo_to_ego_mat(torch.from_numpy(t), torch.from_numpy(R)))


@pytest.mark.parametrize("z_type,is_allo", [("REL", True), ("ABS", True), ("REL", False)])
def test_pose_from_centroid_z_rel(z_type, is_allo):
    a = _site_inputs()
    rj, tj = jse3.pose_from_centroid_z_rel(
        *[jnp.asarray(v) for v in a.values()], is_allo=is_allo, z_type=z_type)
    rt, tt = tse3.pose_from_centroid_z_rel(
        *[torch.from_numpy(v) for v in a.values()], is_allo=is_allo, z_type=z_type)
    _close(rj, rt)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=TOL)


def test_pose_from_centroid_z_abs_and_trans():
    a = _site_inputs(seed=4)
    cen = a["roi_centers"]
    rj, tj = jse3.pose_from_centroid_z_abs(
        jnp.asarray(a["rot_allo"]), jnp.asarray(cen), jnp.asarray(a["z_rel"]),
        jnp.asarray(a["roi_cams"]))
    rt, tt = tse3.pose_from_centroid_z_abs(
        torch.from_numpy(a["rot_allo"]), torch.from_numpy(cen),
        torch.from_numpy(a["z_rel"]), torch.from_numpy(a["roi_cams"]))
    _close(rj, rt)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=TOL)
    trans = np.random.RandomState(5).randn(7, 3).astype(np.float32) + [0, 0, 2]
    rj, _ = jse3.pose_from_trans(jnp.asarray(a["rot_allo"]), jnp.asarray(trans))
    rt, _ = tse3.pose_from_trans(torch.from_numpy(a["rot_allo"]),
                                 torch.from_numpy(trans.astype(np.float32)))
    _close(rj, rt)

