"""Port parity: every GDRN variant the JAX ``models/gdrn.py`` builds.

Whole-model cases on the tiny config (64 -> 16, 3 classes, fp32), the JAX
model and the port given the same numpy-drawn parameters through
``state_dict_from_flax``. Each case covers one or more variants that do not
interact (one JAX compile per variant would take ~70 s). The forward-only
cases use resnet34 as the backbone (it traces and compiles in JAX in ~60% of
convnext_tiny's time; the FPN case keeps convnext_tiny, the layout the card
serves). Outputs are held at 1e-4 of each output's scale, as
``tests/test_torch_gdrn.py`` holds the flagship.

The single-mask and cls2reg cases also hold the gradient of the GDRN loss
with respect to every parameter against ``jax.grad`` (loss only, no
optimizer), mapped into the port's names by the same bridge (it is linear:
transposes, flips and channel permutations), at 1e-4 of each tensor's
largest. They use convnext_tiny: flax's ``nn.GroupNorm`` computes the
variance in one pass, E[x^2] - E[x]^2 in fp32, and a ResNet's stage-2 groups
have means large against their spread (the residual sums are not
normalised), so resnet34's backbone gradients differ from the port's by up
to 5.6e-3 of their largest; with a two-pass variance in flax they agree to
2.3e-5, and the port moved by 1e-7 of its input moves them by 2.5e-5 (checks
made once, not in this file). The whole ResNet forward holds at 1e-4.

cls2reg is held looser, as follows. Its PnP net reads ``soft_argmax`` over
the bins at beta = 1000, which turns the ~5e-6 relative difference of the
two packages' out-conv logits (held at 1e-4 like every other output) into
larger ones where two bins nearly tie, and multiplies the gradient through
it by beta.
  * Pose outputs at 1e-3 of their scale: over parameter seeds 11, 21 and 31
    (resnet34) the rotation differed by 1.4e-5, 2.7e-5 and 1.5e-4 of its
    scale (rot_allo 1.7e-4 at seed 31).
  * Gradients at 1e-2 of each tensor's largest: 1.4e-3 and 3.4e-3 at seeds
    13 and 23 (convnext_tiny), where the single-mask model reads 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.geometry.symmetry import build_sym_bank as j_sym_bank
from gdrnpp_bop2022_tpu.losses.gdrn_losses import compute_gdrn_losses as j_losses
from gdrnpp_bop2022_tpu.utils.fake_data import fake_gdrn_batch
from gdrnpp_bop2022_torch.geometry.symmetry import build_sym_bank
from gdrnpp_bop2022_torch.losses.gdrn_losses import compute_gdrn_losses
from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
from gdrnpp_bop2022_torch.utils.weights import state_dict_from_flax
from torch_parity_utils import jax_gdrn_params, port_gdrn, roi_batch, tiny_cfg, to_torch

P = "model.pose_net."
_KEYS = ("rot", "trans", "rot_allo", "centroid_rel", "z_rel", "vis_mask",
         "full_mask", "coor_x", "coor_y", "coor_z", "region")
_POSE = ("rot", "trans", "rot_allo", "centroid_rel", "z_rel")
CLS2REG_POSE_TOL = 1e-3
CLS2REG_GRAD_TOL = 1e-2
_CLS2REG = {P + "name": "gdrn_cls2reg", P + "geo_head.name": "top_down_mask_xyz_region",
            P + "loss.xyz_loss_type": "CE_coor", P + "geo_head.xyz_num_bins": 8,
            P + "pnp_net.name": "conv_pnp_net_cls"}
_SINGLE = {P + "geo_head.name": "top_down_mask_xyz_region"}

_BB = {P + "backbone.name": "resnet34"}
CASES = {
    "pnp_ln_in6": {P + "pnp_net.norm": "LN", P + "backbone.in_channels": 6},
    "single_mask_ce_no_region_pnp_none": {
        **_SINGLE, P + "loss.mask_loss_type": "CE", P + "geo_head.num_regions": 0,
        P + "pnp_net.region_attention": False, P + "pnp_net.norm": "none"},
    "ce_coor_bins": {P + "loss.xyz_loss_type": "CE_coor", P + "geo_head.xyz_num_bins": 8},
    "conv_head_acon": {P + "geo_head.name": "conv_mask_xyz_region",
                       P + "backbone.out_index": 0, P + "geo_head.act": "acon"},
    "fpn_head": {P + "geo_head.name": "fpn_mask_xyz_region",
                 P + "backbone.name": "convnext_tiny"},
    # with bilinear up-blocks only, "acon" reaches ConvModule alone (AconC)
    "point_pnp_bilinear_acon": {P + "pnp_net.name": "point_pnp", P + "geo_head.act": "acon",
                                P + "geo_head.up_types": ("bilinear", "bilinear", "bilinear")},
    "dstream_conv_fuse": {P + "name": "gdrn_dstream_double_mask", P + "fuse_type": "conv"},
}
_SINGLE_MASK = ("single_mask_ce_no_region_pnp_none", "conv_head_acon", "fpn_head")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    b = roi_batch(cfg, B=3, seed=seed)
    if "dstream" in cfg.model.pose_net.name:
        b["roi_depth"] = np.random.RandomState(seed + 1).uniform(
            -0.5, 1.0, (3, 64, 64, 3)).astype(np.float32)
    return b


def _check_outputs(got, want, pose_tol=1e-4):
    for k in _KEYS:
        if want[k] is None:
            assert got[k] is None, k
            continue
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        scale = max(np.abs(w).max(initial=0.0), 1.0)
        tol = pose_tol if k in _POSE else 1e-4
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=tol, atol=tol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_variant_matches_jax(case):
    cfg = tiny_cfg(**{**_BB, **CASES[case]})
    jm, params = jax_gdrn_params(cfg, seed=11)
    port = port_gdrn(cfg, params)
    b = _batch(cfg, seed=12)
    want = jax.jit(jm.apply)({"params": params}, **{k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = port(**to_torch(b))
    _check_outputs(got, want)
    assert (got["full_mask"] is None) == (case in _SINGLE_MASK)
    if case == "point_pnp_bilinear_acon":
        assert "acon" in params["geo_head"]["up0"]["conv0"]


@pytest.mark.parametrize("case", ["single_mask", "cls2reg_pnp_cls"])
def test_variant_outputs_and_loss_gradients_match_jax(case):
    cls2reg = case == "cls2reg_pnp_cls"
    cfg = tiny_cfg(**{**(_CLS2REG if cls2reg else _SINGLE), P + "loss.full_mask_lw": 0.0})
    pc = cfg.model.pose_net
    jm, params = jax_gdrn_params(cfg, seed=13)
    port = port_gdrn(cfg, params)
    fb = fake_gdrn_batch(2, pc.input_res, pc.output_res, pc.num_classes,
                         pc.geo_head.num_regions, num_points=16, seed=14,
                         with_bins=pc.loss.xyz_loss_type == "CE_coor",
                         xyz_bins=pc.geo_head.xyz_num_bins)
    keys = ("roi_img", "roi_labels", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
            "roi_extents", "resize_ratios")
    jb = {k: jnp.asarray(v) for k, v in fb.items()}
    jsym = j_sym_bank([None] * pc.num_classes)

    def jloss(p):
        out = jm.apply({"params": p}, **{k: jb[k] for k in keys})
        return sum(j_losses(cfg, {**out, "rot_ego": out["rot"]}, jb, *jsym).values()), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in fb.items()}
    out = port(**{k: tb[k] for k in keys})
    _check_outputs(out, jout, CLS2REG_POSE_TOL if cls2reg else 1e-4)
    assert out["full_mask"] is None
    losses = compute_gdrn_losses(cfg, {**out, "rot_ego": out["rot"]}, tb,
                                 *build_sym_bank([None] * pc.num_classes))
    assert "loss_mask_full" not in losses
    total = sum(losses.values())
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-4)
    total.backward()
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, jg), cfg)
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    tol = CLS2REG_GRAD_TOL if cls2reg else 1e-4
    for k, w in want.items():
        g = got[k].grad
        g = torch.zeros_like(w) if g is None else g
        assert float((g - w).abs().max()) <= tol * float(w.abs().max()) + 1e-7, k


def test_unknown_names_raise():
    for over in ({P + "backbone.name": "nope"}, {P + "geo_head.name": "nope"},
                 {P + "pnp_net.name": "nope"}):
        with pytest.raises(ValueError, match="Unknown"):
            build_gdrn(tiny_cfg(**over), device="cpu")
    with pytest.raises(ValueError, match="binned"):
        build_gdrn(tiny_cfg(**{P + "name": "gdrn_cls2reg"}), device="cpu")
    with pytest.raises(ValueError, match="single-scale"):
        build_gdrn(tiny_cfg(**{P + "name": "gdrn_dstream_double_mask",
                               P + "geo_head.name": "fpn_mask_xyz_region"}), device="cpu")


@pytest.mark.parametrize("where", ["deconv_head", "pnp_fc"])
def test_acon_raises_where_jax_raises(where):
    """``get_act`` has no "acon": the JAX package raises on it in a deconv
    up-block and in ConvPnPNet's FCs, and so does the port."""
    over = ({P + "geo_head.act": "acon"} if where == "deconv_head"
            else {P + "pnp_net.act": "acon"})
    cfg = tiny_cfg(**_BB, **over)
    with pytest.raises(ValueError, match="acon"):
        jax_gdrn_params(cfg)
    with pytest.raises(ValueError, match="acon"):
        build_gdrn(cfg, device="cpu")


def test_gradient_centralization_matches_jax_layouts():
    """Ranger centralizes each gradient over axes 1.. of its flax layout; the
    port maps that onto torch layouts by rank. Every parameter of the
    variants' modules must land in a layout where the two agree: a random
    "gradient" tree centralized by the JAX rule and bridged equals the
    bridged tree centralized by the port's Ranger. One GDRN holds the conv
    head with AconC and ConvPnPNetCls with LN (ConvFuseNet's convs and
    GroupNorms and SimplePointPnPNet's linear layers have the layouts of
    convs, norms and FCs held here); ResNeSt's split attention is checked
    alone."""
    from gdrnpp_bop2022_tpu.models.backbones.resnest import SplitAttention as JSplat
    from gdrnpp_bop2022_tpu.solver.ranger import _centralize
    from gdrnpp_bop2022_torch.solver.ranger import Ranger
    from gdrnpp_bop2022_torch.utils.weights import _affine, _conv, _dense
    from torch_parity_utils import random_like_tree
    centre = jax.jit(lambda t: jax.tree_util.tree_map(_centralize, t))
    cfg = tiny_cfg(**{**_BB, P + "backbone.out_index": 0,
                      P + "geo_head.name": "conv_mask_xyz_region", P + "geo_head.act": "acon",
                      P + "pnp_net.name": "conv_pnp_net_cls", P + "pnp_net.norm": "LN"})
    _, grads = jax_gdrn_params(cfg, seed=17)
    bridge = lambda t: state_dict_from_flax(jax.tree_util.tree_map(np.array, t), cfg)  # noqa: E731
    pairs = [(bridge(grads), bridge(centre(grads)))]
    splat = JSplat(64, dtype=jnp.float32)
    g = random_like_tree(jax.eval_shape(lambda k: splat.init(k, jnp.zeros((1, 4, 4, 64))),
                                        jax.random.PRNGKey(0))["params"], 20)

    def splat_sd(t):
        t = jax.tree_util.tree_map(np.array, t)
        return {"conv.weight": _conv(t["conv"]["kernel"]), **_dense(t["fc1"], "fc1"),
                **_dense(t["fc2"], "fc2"), **_affine(t["norm0"]["GroupNorm_0"], "bn0"),
                **_affine(t["norm1"]["GroupNorm_0"], "bn1")}
    pairs.append((splat_sd(g), splat_sd(centre(g))))
    opt = Ranger([torch.nn.Parameter(torch.zeros(1))], 1e-3)
    for raw, want in pairs:
        for k, v in raw.items():
            s = torch.as_tensor(np.ascontiguousarray(v, np.float32))[None].clone()
            opt._precondition([s])
            np.testing.assert_allclose(s[0].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


def test_simple_point_pnp_softpool_matches_jax():
    """SimplePointPnPNet with the top-k "softpool", held at module level: the
    JAX GDRN builds the net with the global max pool only (it never sets
    ``use_softpool``). fp32, 1e-4 of each output's scale."""
    from gdrnpp_bop2022_tpu.config import PnPNetConfig
    from gdrnpp_bop2022_tpu.models.heads.point_pnp_net import SimplePointPnPNet as JPoint
    from gdrnpp_bop2022_torch.models.heads.point_pnp_net import SimplePointPnPNet
    from gdrnpp_bop2022_torch.utils.weights import _pnp_net
    from torch_parity_utils import random_like_tree
    rs = np.random.RandomState(18)
    coor = rs.rand(2, 8, 8, 5).astype(np.float32)
    region = rs.rand(2, 8, 8, 6).astype(np.float32)
    ext = rs.uniform(0.05, 0.2, (2, 3)).astype(np.float32)
    jn = JPoint(use_softpool=True, softpool_topk=8, dtype=jnp.float32)
    jargs = [jnp.asarray(a) for a in (coor, region, ext)]
    params = random_like_tree(jax.eval_shape(lambda k: jn.init(k, *jargs),
                                             jax.random.PRNGKey(0))["params"], 19)
    rot_j, t_j = jn.apply({"params": params}, *jargs)
    tn = SimplePointPnPNet(11, use_softpool=True, softpool_topk=8, dtype=torch.float32)
    tn.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                        _pnp_net(params, PnPNetConfig(name="point_pnp"), 8).items()}, strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)     # noqa: E731
    with torch.no_grad():
        rot_t, t_t = tn(nchw(coor), nchw(region), torch.from_numpy(ext))
    for got, want in ((rot_t, rot_j), (t_t, t_j)):
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1.0))
