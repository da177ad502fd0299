"""The work counters against hand counts at one small shape."""

import pytest

from bench_h100 import counts

P = "model.pose_net."
ARCH = {P + "name": "gdrn_double_mask", P + "num_classes": 2, P + "input_res": 32,
        P + "output_res": 8, P + "fuse_type": "cat", P + "backbone.in_channels": 3,
        P + "backbone.gelu_exact": False, P + "geo_head.name": "top_down_doublemask_xyz_region",
        P + "geo_head.up_types": ["deconv", "bilinear", "bilinear"],
        P + "geo_head.deconv_kernel_size": 3, P + "geo_head.num_conv_per_block": 2,
        P + "geo_head.feat_dim": 16, P + "geo_head.feat_kernel_size": 3,
        P + "geo_head.num_gn_groups": 4, P + "geo_head.act": "gelu",
        P + "geo_head.out_kernel_size": 1, P + "geo_head.num_regions": 4,
        P + "pnp_net.name": "conv_pnp_net", P + "pnp_net.featdim": 8,
        P + "pnp_net.num_stride2_layers": 3, P + "pnp_net.num_gn_groups": 4,
        P + "pnp_net.act": "gelu", P + "pnp_net.flat_op": "flatten",
        P + "pnp_net.denormalize_by_extent": True, P + "pnp_net.region_attention": True,
        P + "pnp_net.mask_attention": "none", P + "pnp_net.with_2d_coord": True,
        P + "pnp_net.coord_2d_type": "abs", P + "pnp_net.rot_type": "allo_rot6d",
        P + "pnp_net.trans_type": "centroid_z", P + "pnp_net.z_type": "REL",
        P + "loss.xyz_loss_type": "L1", P + "loss.mask_loss_type": "L1",
        "model.compute_dtype": "bfloat16", "input.bp_depth": True,
        "widths": {"backbone_depths": [1, 1, 1, 1], "backbone_dims": [8, 16, 32, 64],
                   "pnp_fc": [16, 8]}}


def test_flops_per_roi_by_hand():
    # multiply-adds of one ROI at 32 in, 8 out; each stage's maps are 8, 4, 2, 1 px square
    block = lambda c, px: c * 49 * px + 2 * (px * c * 4 * c)          # noqa: E731 dw + MLP
    backbone = (8 * 3 * 16 * 64 + block(8, 64)                         # stem, stage 0
                + 16 * 8 * 4 * 16 + block(16, 16)                      # downsample, stage 1
                + 32 * 16 * 4 * 4 + block(32, 4)
                + 64 * 32 * 4 * 1 + block(64, 1))
    head = (64 * 16 * 9 * 1                                            # deconv from 1x1
            + 2 * 16 * 16 * 9 * 4 + 2 * 16 * 16 * 9 * 16 + 2 * 16 * 16 * 9 * 64
            + (2 + 3 + 5) * 2 * 16 * 64)                               # out conv, 2 classes
    pnp = 8 * 9 * 9 * 16 + 8 * 8 * 9 * 4 + 8 * 8 * 9 * 1 + 8 * 16 + 16 * 8 + 8 * 6 + 8 * 3
    decode = 27                                                        # the allo -> ego product
    assert counts.flops_per_roi(ARCH) == 2 * (backbone + head + pnp + decode)


def test_flops_per_roi_of_the_dual_stream_counts_both_backbones():
    dual = {**ARCH, P + "name": "gdrn_dstream_double_mask"}
    extra_backbone = counts.flops_per_roi(dual) - counts.flops_per_roi(ARCH)
    # the second backbone, and the deconv's doubled input channels
    block = lambda c, px: c * 49 * px + 2 * (px * c * 4 * c)          # noqa: E731
    backbone = (8 * 3 * 16 * 64 + block(8, 64) + 16 * 8 * 4 * 16 + block(16, 16)
                + 32 * 16 * 4 * 4 + block(32, 4) + 64 * 32 * 4 * 1 + block(64, 1))
    assert extra_backbone == 2 * (backbone + 64 * 16 * 9)


@pytest.mark.parametrize("batch", [1, 64])
def test_layer_norm_bytes_by_hand(batch):
    shapes = [(64, 8), (64, 8), (64, 8), (16, 16), (16, 16), (4, 32), (4, 32), (1, 64)]
    assert counts.layer_norm_shapes(ARCH) == shapes
    want = sum(batch * r * c * (2 + 2) + 2 * c * 4 for r, c in shapes)
    assert counts.layer_norm_bytes(ARCH, batch) == want


def test_convnext_base_has_forty_layer_norms_at_the_bound_chip_smoke_used():
    import json
    from pathlib import Path
    conf = json.loads((Path(counts.__file__).parent / "configs" / "ycbv_convnext_base.json")
                      .read_text())
    arch = {**conf["model"], "widths": conf["widths"]}
    assert len(counts.layer_norm_shapes(arch)) * counts.backbones(arch) == 40
    # 1.930 GB a forward at batch 64: 0.5760 ms at 3.35 TB/s
    assert abs(counts.layer_norm_bytes(arch, 64) / 3.35e12 * 1e3 - 0.5760) < 5e-4
