"""Port parity: the whole GDRN model, and the weight bridge.

The model test runs the JAX GDRN and the port on the same batch with the
same numpy-drawn parameters (tiny config: convnext_tiny, 64 -> 16,
3 classes, fp32, tanh GELU). Tolerance 1e-4 relative to each output's
scale: ~20 conv/norm layers in fp32 with sums in another order.

The bridge tests hold ``state_dict_from_flax`` to be the exact inverse of
the JAX package's ``convert_gdrn_checkpoint``, for the tiny tree and for
the flagship tree (shapes from ``jax.eval_shape``: no flagship forward
runs here), and the port's modules to load the result with strict=True.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.config import Config
from gdrnpp_bop2022_tpu.utils.torch_port import convert_gdrn_checkpoint
from gdrnpp_bop2022_torch.models.gdrn import GDRN, build_gdrn, xyz_mask_region_out_dims
from gdrnpp_bop2022_torch.models.heads.conv_pnp_net import final_spatial
from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict, state_dict_from_flax
from torch_parity_utils import jax_gdrn_params, port_gdrn, roi_batch, tiny_cfg, to_torch

_KEYS = ("rot", "trans", "rot_allo", "centroid_rel", "z_rel", "vis_mask",
         "full_mask", "coor_x", "coor_y", "coor_z", "region")


@pytest.mark.parametrize("overrides", [
    {},
    {"model.pose_net.backbone.gelu_exact": True,
     "model.pose_net.pnp_net.rot_type": "ego_rot6d",
     "model.pose_net.pnp_net.mask_attention": "concat"},
    # the deconv up-block's norm follows geo_head.norm (it was always a GN)
    {"model.pose_net.geo_head.norm": "LN"},
], ids=["flagship_recipe", "exact_gelu_ego_maskatt", "geo_head_ln"])
def test_gdrn_matches_jax(overrides):
    cfg = tiny_cfg(**overrides)
    jm, params = jax_gdrn_params(cfg, seed=0)
    port = port_gdrn(cfg, params)
    b = roi_batch(cfg, B=3, seed=1)
    want = jm.apply({"params": params}, **{k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = port(**to_torch(b))
    for k in _KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0), err_msg=k)


def _bridge_kwargs(cfg):
    pc = cfg.model.pose_net
    xyz, mask, region = xyz_mask_region_out_dims(pc)
    depths = {"convnext_tiny": (3, 3, 9, 3)}.get(pc.backbone.name, (3, 3, 27, 3))
    return dict(depths=depths, up_types=pc.geo_head.up_types,
                num_conv_per_block=pc.geo_head.num_conv_per_block,
                num_stride2_layers=pc.pnp_net.num_stride2_layers,
                num_extra_layers=pc.pnp_net.num_extra_layers,
                flat_op=pc.pnp_net.flat_op,
                final_spatial=final_spatial(pc.output_res,
                                            pc.pnp_net.num_stride2_layers),
                mask_out_dim=mask, xyz_out_dim=xyz, region_out_dim=region,
                num_classes=pc.num_classes)


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_bridge_is_inverse_of_convert_gdrn_checkpoint(which):
    cfg = tiny_cfg() if which == "tiny" else Config()
    _, params = jax_gdrn_params(cfg, seed=2)
    sd = state_dict_from_flax(params, cfg)
    back = convert_gdrn_checkpoint({k: v.numpy() for k, v in sd.items()},
                                   params, **_bridge_kwargs(cfg))
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_b) == len(flat_p)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path]), leaf), path
    # every converted tensor lands in a port parameter of the same shape
    with torch.device("meta"):
        model = GDRN(cfg.model.pose_net, dtype=torch.float32)
    missing, unexpected = model.load_state_dict(sd, strict=True, assign=True)
    assert not missing and not unexpected


def test_flagship_names_follow_reference():
    with torch.device("meta"):
        model = GDRN(Config().model.pose_net)
    names = set(model.state_dict())
    for k in ("backbone.stem.0.weight", "backbone.stages.2.blocks.26.mlp.fc2.weight",
              "geo_head_net.features.0.weight", "geo_head_net.features.1.weight",
              "geo_head_net.features.3.conv.weight", "geo_head_net.features.4.gn.bias",
              "geo_head_net.features.6.conv.weight", "geo_head_net.out_layer.weight",
              "pnp_net.features.0.weight", "pnp_net.features.7.bias",
              "pnp_net.fc1.weight", "pnp_net.fc2.bias", "pnp_net.fc_r.weight",
              "pnp_net.fc_t.bias"):
        assert k in names, k
    assert model.state_dict()["pnp_net.fc1.weight"].shape == (1024, 128 * 8 * 8)
    # 21 classes x (2 mask + 3 xyz + 65 region) out channels, group-major
    assert model.state_dict()["geo_head_net.out_layer.weight"].shape[0] == 21 * 70


def test_seeded_state_dict_is_deterministic_and_loads():
    cfg = tiny_cfg()
    m = build_gdrn(cfg, device="cpu")
    a, b = seeded_state_dict(m, 5), seeded_state_dict(m, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    m.load_state_dict(a, strict=True)
    assert float(m.backbone.stages[0].blocks[0].gamma.detach().min()) >= 0.1


def test_bf16_forward_keeps_fp32_islands():
    """bf16 compute: the dense outputs (fp32 out conv) and the pose decode
    stay fp32 and finite."""
    cfg = tiny_cfg(**{"model.compute_dtype": "bfloat16"})
    m = build_gdrn(cfg, device="cpu")
    m.load_state_dict(seeded_state_dict(m, 0))
    with torch.no_grad():
        out = m(**to_torch(roi_batch(cfg, B=2)))
    for k in _KEYS:
        assert out[k].dtype == torch.float32, k
        assert torch.isfinite(out[k]).all(), k
    R = out["rot"]
    eye = torch.eye(3).expand_as(R)
    assert (R.transpose(1, 2) @ R - eye).abs().max() < 1e-3


def test_unported_variants_raise():
    """Every variant the JAX GDRN builds is ported: the three that
    raised NotImplementedError build, and only unknown names raise, with
    ValueError as in the JAX package (tests/test_torch_gdrn_variants.py holds
    each variant to JAX)."""
    from gdrnpp_bop2022_tpu.config import replace_cfg
    for over in ({"model.pose_net.backbone.name": "resnet34"},
                 {"model.pose_net.geo_head.name": "conv_mask_xyz_region"},
                 {"model.pose_net.pnp_net.name": "conv_pnp_net_cls"}):
        build_gdrn(replace_cfg(tiny_cfg(), over), device="cpu")
    with pytest.raises(ValueError, match="Unknown backbone"):
        build_gdrn(replace_cfg(tiny_cfg(), {"model.pose_net.backbone.name": "resnet35"}),
                   device="cpu")


_DSTREAM = {"model.pose_net.name": "gdrn_dstream_double_mask"}


@pytest.mark.parametrize("fuse_type", ["cat", "add"])
def test_dstream_gdrn_matches_jax(fuse_type):
    """RGB-D dual stream (second convnext_tiny over a backprojected depth
    ROI), fused by concat or sum: same outputs as the JAX model, at the
    tolerance of the RGB model above."""
    cfg = tiny_cfg(**_DSTREAM, **{"model.pose_net.fuse_type": fuse_type})
    jm, params = jax_gdrn_params(cfg, seed=4)
    assert "depth_backbone" in params
    port = port_gdrn(cfg, params)
    assert port.depth_backbone is not None
    b = roi_batch(cfg, B=2, seed=5)
    rs = np.random.RandomState(6)
    b["roi_depth"] = np.concatenate([rs.uniform(-0.2, 0.2, (2, 64, 64, 2)),
                                     rs.uniform(0.4, 1.2, (2, 64, 64, 1))],
                                    -1).astype(np.float32)
    want = jm.apply({"params": params}, **{k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = port(**to_torch(b))
    for k in _KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0), err_msg=k)
    with pytest.raises(ValueError, match="roi_depth"):
        port(**to_torch({k: v for k, v in b.items() if k != "roi_depth"}))


def test_dstream_bridge_is_inverse_of_convert_gdrn_checkpoint():
    cfg = tiny_cfg(**_DSTREAM)
    _, params = jax_gdrn_params(cfg, seed=7)
    sd = state_dict_from_flax(params, cfg)
    assert any(k.startswith("depth_backbone.stem.0") for k in sd)
    back = convert_gdrn_checkpoint({k: v.numpy() for k, v in sd.items()},
                                   params, **_bridge_kwargs(cfg))
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        assert np.array_equal(np.asarray(flat_b[path]), leaf), path


def test_dstream_conv_fusion_raises():
    """ConvFuseNet is ported: fuse_type="conv" builds it; what
    raises is the dual stream with the multi-scale FPN head, as in JAX."""
    cfg = tiny_cfg(**_DSTREAM, **{"model.pose_net.fuse_type": "conv"})
    assert build_gdrn(cfg, device="cpu").fuse_net is not None
    with pytest.raises(ValueError, match="single-scale"):
        build_gdrn(tiny_cfg(**_DSTREAM, **{"model.pose_net.geo_head.name":
                                           "fpn_mask_xyz_region"}), device="cpu")


def test_rgbd_flagship_has_two_backbones_of_40_layer_norms():
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd
    from gdrnpp_bop2022_torch.models.backbones.convnext import LayerNorm2d
    with torch.device("meta"):
        model = GDRN(ycbv_convnext_base_rgbd().model.pose_net)
    for bb in (model.backbone, model.depth_backbone):
        assert sum(isinstance(m, LayerNorm2d) for m in bb.modules()) == 40
    # cat fusion: the geo head reads 2 x 1024 channels
    assert model.geo_head_net.features[0].weight.shape[0] == 2048


@pytest.mark.parametrize("bp_depth", [True, False])
def test_build_depth_rois_matches_jax(bp_depth):
    from gdrnpp_bop2022_tpu.engine.batching import build_depth_rois as j_build
    from gdrnpp_bop2022_torch.engine.batching import build_depth_rois
    rs = np.random.RandomState(8)
    depth = rs.uniform(0.3, 1.2, (3, 50, 70)).astype(np.float32)
    depth[:, :6] = 0.0
    img_idx = np.array([0, 2, 1, 2], np.int32)
    centers = rs.uniform(10, 60, (4, 2)).astype(np.float32)
    scales = rs.uniform(20, 90, 4).astype(np.float32)
    Ks = np.tile(np.array([[120.0, 0.5, 35.0], [0, 118.0, 25.0], [0, 0, 1]],
                          np.float32), (4, 1, 1))
    want = np.asarray(j_build(jnp.asarray(depth), jnp.asarray(img_idx),
                              jnp.asarray(centers), jnp.asarray(scales),
                              jnp.asarray(Ks), input_res=24, bp_depth=bp_depth))
    got = build_depth_rois(*(torch.from_numpy(a) for a in (depth, img_idx, centers,
                                                            scales, Ks)),
                           input_res=24, bp_depth=bp_depth)
    assert got.shape == want.shape == (4, 24, 24, 3 if bp_depth else 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
