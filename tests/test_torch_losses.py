"""Port parity: the GDRN loss dict and its gradients against the JAX package.

Every branch of ``compute_gdrn_losses`` runs on the same random outputs and
targets (numpy, seeded) through ``gdrnpp_bop2022_tpu.losses.gdrn_losses``
and the port: xyz L1 and CE_coor (with each mask target), the mask losses
L1 / BCE / dice / RW_BCE, region CE, point matching (symmetric through a
symmetry bank, R only, RT, disentangled t and z with and without points,
smooth L1), rotation (angular, MSE), centroid, z (REL, ABS), translation
(disentangled or not, L1 / L2) and bind, a frozen geo head, and the
learned task weights of ``use_mtl``. Each loss
value and the gradient of the total with respect to every model output
agree at 1e-5 (relative and absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.config import Config as JConfig, replace_cfg as jreplace
from gdrnpp_bop2022_tpu.geometry.symmetry import build_sym_bank as j_sym_bank
from gdrnpp_bop2022_tpu.losses.gdrn_losses import compute_gdrn_losses as j_losses
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.geometry.symmetry import build_sym_bank
from gdrnpp_bop2022_torch.losses.gdrn_losses import compute_gdrn_losses

B, R, NREG, BINS, NPTS, NCLS = 3, 8, 6, 16, 20, 3
L = "model.pose_net.loss."

CASES = {
    "default": {},
    "ce_bce_dice_rot_bind": {L + "xyz_loss_type": "CE_coor", L + "xyz_loss_mask_gt": "trunc",
                             L + "mask_loss_type": "BCE", L + "full_mask_loss_type": "dice",
                             L + "rot_lw": 1.0, L + "trans_lw": 1.0, L + "bind_lw": 0.5,
                             L + "region_loss_mask_gt": "obj"},
    "rwbce_rt_mse_l2_abs": {L + "mask_loss_type": "RW_BCE", L + "full_mask_loss_type": "BCE",
                            L + "pm_r_only": False, L + "pm_loss_type": "smooth_l1",
                            L + "pm_smooth_l1_beta": 0.05, L + "rot_lw": 1.0,
                            L + "rot_loss_type": "mse", L + "trans_lw": 1.0,
                            L + "trans_loss_disentangle": False, L + "trans_loss_type": "L2",
                            L + "centroid_loss_type": "L2", L + "z_loss_type": "MSE",
                            "model.pose_net.pnp_net.z_type": "ABS",
                            L + "xyz_loss_mask_gt": "obj", L + "mask_loss_gt": "visib"},
    "pm_disentangle_t": {L + "pm_r_only": False, L + "pm_disentangle_t": True,
                         L + "pm_loss_type": "mse", L + "pm_norm_by_extent": False},
    "pm_disentangle_t_nop": {L + "pm_r_only": False, L + "pm_disentangle_t": True,
                             L + "pm_t_use_points": False, L + "pm_loss_sym": False},
    "pm_disentangle_z": {L + "pm_r_only": False, L + "pm_disentangle_z": True,
                         L + "z_loss_type": "L2"},
    "pm_disentangle_z_nop": {L + "pm_r_only": False, L + "pm_disentangle_z": True,
                             L + "pm_t_use_points": False},
    "frozen_geo_head": {"model.pose_net.geo_head.freeze": True, L + "trans_lw": 1.0},
}

OUT_KEYS = ("vis_mask", "full_mask", "coor_x", "coor_y", "coor_z", "region", "rot_ego",
            "trans", "centroid_rel", "z_rel")


def _rot(rs, n):
    q, _ = np.linalg.qr(rs.randn(n, 3, 3))
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


def _data(cfg, seed=0):
    rs = np.random.RandomState(seed)
    ce = cfg.model.pose_net.loss.xyz_loss_type == "CE_coor"
    cdim = BINS + 1 if ce else 1
    f = lambda *s: rs.randn(*s).astype(np.float32)        # noqa: E731
    outputs = {"vis_mask": f(B, R, R), "full_mask": f(B, R, R), "coor_x": f(B, R, R, cdim),
               "coor_y": f(B, R, R, cdim), "coor_z": f(B, R, R, cdim),
               "region": f(B, R, R, NREG + 1), "rot_ego": _rot(rs, B),
               "trans": (f(B, 3) * 0.1 + [0, 0, 0.8]).astype(np.float32),
               "centroid_rel": f(B, 2) * 0.1, "z_rel": f(B) * 0.2 + 1.0}
    m = lambda: (rs.rand(B, R, R) > 0.4).astype(np.float32)    # noqa: E731
    batch = {"gt_xyz": rs.rand(B, R, R, 3).astype(np.float32),
             "gt_xyz_bin": rs.randint(0, BINS + 1, (B, R, R, 3)).astype(np.int32),
             "gt_mask_trunc": m(), "gt_mask_visib": m(), "gt_mask_obj": m(),
             "gt_mask_full": rs.rand(B, R, R).astype(np.float32),
             "gt_region": rs.randint(0, NREG + 1, (B, R, R)).astype(np.int32),
             "gt_rot": _rot(rs, B), "gt_trans": (f(B, 3) * 0.1 + [0, 0, 0.8]).astype(np.float32),
             "gt_trans_ratio": f(B, 3) * 0.3, "gt_points": f(B, NPTS, 3) * 0.05,
             "roi_extents": rs.uniform(0.05, 0.2, (B, 3)).astype(np.float32),
             "roi_labels": np.array([0, 1, 2], np.int32)}
    batch["gt_mask_full"][0, :2] = 0.0            # RW_BCE needs negatives with gt == 0
    return outputs, batch


def _sym_banks():
    """class 0: none; class 1: 2-fold about z; class 2: 4-fold about y."""
    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    rots = [None, np.stack([rz(0), rz(np.pi)]), np.stack([ry(k * np.pi / 2) for k in range(4)])]
    return rots


@pytest.mark.parametrize("case", list(CASES))
def test_losses_and_grads_match_jax(case):
    over = dict(CASES[case], **{"model.pose_net.num_classes": NCLS,
                                "model.pose_net.geo_head.num_regions": NREG,
                                "model.pose_net.geo_head.xyz_num_bins": BINS})
    jcfg, tcfg = jreplace(JConfig(), over), replace_cfg(Config(), over)
    outputs, batch = _data(tcfg)
    jb, jm = j_sym_bank(_sym_banks())
    tb, tm = build_sym_bank(_sym_banks())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jtotal(outs):
        losses = j_losses(jcfg, outs, jbatch, sym_bank=jb, sym_mask=jm)
        return sum(losses.values()), losses

    (jt, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    touts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in outputs.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlosses = compute_gdrn_losses(tcfg, touts, tbatch, sym_bank=tb, sym_mask=tm)
    # the same keys in the same order (the total sums them in that order;
    # value_and_grad's aux comes back with sorted keys)
    assert list(tlosses) == list(j_losses(jcfg, {k: jnp.asarray(v) for k, v in outputs.items()},
                                          jbatch, sym_bank=jb, sym_mask=jm))
    for k in jlosses:
        np.testing.assert_allclose(float(tlosses[k]), float(jlosses[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    total = sum(tlosses.values())
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-5, atol=1e-5)
    total.backward()
    for k in OUT_KEYS:
        g = touts[k].grad
        want = np.asarray(jgrads[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
    if case == "default":
        assert set(jlosses) == {"loss_coor_x", "loss_coor_y", "loss_coor_z", "loss_mask",
                                "loss_mask_full", "loss_region", "loss_PM_R",
                                "loss_centroid", "loss_z"}


def test_use_mtl_raises():
    """use_mtl: every term weighted by its learned log-variance, L exp(-a) +
    log(1 + exp(a)), equal to the JAX package's dict at 1e-5 with the
    gradients of the total with respect to the outputs and the
    log-variances; without log-variances the port raises (it would train
    another recipe) where the JAX package leaves the terms unweighted."""
    from gdrnpp_bop2022_torch.models.gdrn import MTL_NAMES
    over = dict(CASES["ce_bce_dice_rot_bind"], **{
        L + "use_mtl": True, "model.pose_net.num_classes": NCLS,
        "model.pose_net.geo_head.num_regions": NREG, "model.pose_net.geo_head.xyz_num_bins": BINS})
    cfg = replace_cfg(Config(), over)
    jcfg = jreplace(JConfig(), over)
    outputs, batch = _data(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jsym, tsym = j_sym_bank(_sym_banks()), build_sym_bank(_sym_banks())
    with pytest.raises(ValueError, match="log_vars"):
        compute_gdrn_losses(cfg, {k: torch.from_numpy(v) for k, v in outputs.items()}, tb, *tsym)
    lv = {n: np.float32(v) for n, v in
          zip(MTL_NAMES, np.random.RandomState(5).randn(len(MTL_NAMES)) * 0.5)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jtotal(outs, lvs):
        d = j_losses(jcfg, outs, jb, sym_bank=jsym[0], sym_mask=jsym[1], log_vars=lvs)
        return sum(d.values()), d

    (jt, jd), (jgo, jgl) = jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()}, {k: jnp.asarray(v) for k, v in lv.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    tlv = {k: torch.tensor(v, requires_grad=True) for k, v in lv.items()}
    td = compute_gdrn_losses(cfg, touts, tb, *tsym, log_vars=tlv)
    assert set(td) == set(jd) and len(td) >= 8
    for k in jd:
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    total = sum(td.values())
    total.backward()
    for k in OUT_KEYS:
        g = touts[k].grad
        want = np.asarray(jgo[k])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
    for k in lv:
        g = tlv[k].grad
        np.testing.assert_allclose(0.0 if g is None else float(g), float(jgl[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"log_var_{k}")
