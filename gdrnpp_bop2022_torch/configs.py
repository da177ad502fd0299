"""Named configurations the port serves and trains.

``ycbv_convnext_base`` is the GDRN BOP'22 flagship training recipe for
YCB-V, the same overrides as ``configs/gdrn/ycbv_convnext_base.py``:
convnext_base at 256 -> 64, 21 classes, bf16, batch 48, Ranger at 8e-4 with
flat-and-anneal (anneal at 0.72), online XYZ ground truth.
``ycbv_convnext_base_rgbd`` is the BOP'22 RGB-D recipe for YCB-V, the same
overrides as ``configs/gdrn/ycbv_convnext_base_rgbd.py`` (those files import
the JAX package's config, so the port cannot load them): a dual-stream
convnext_base over RGB and backprojected depth ROIs with concat fusion,
depth refinement at evaluation (2 iterations). ``tests/test_torch_config.py``
holds each equal to its file's ``cfg`` field by field.
"""

from __future__ import annotations

from .config import Config, replace_cfg


def ycbv_convnext_base() -> Config:
    return replace_cfg(Config(), {
        "output_dir": "output/gdrn/ycbv/convnext_base",
        "exp_name": "gdrn_ycbv_convnext_base",
        "model.pose_net.num_classes": 21,
        "model.pose_net.backbone.name": "convnext_base",
        "model.bbox_type": "AMODAL_CLIP",
        "solver.ims_per_batch": 48,
        "solver.total_epochs": 40,
        "solver.base_lr": 8e-4,
        "solver.optimizer": "ranger",
        "solver.anneal_point": 0.72,
        "datasets.train": ("ycbv_train_pbr",),
        "datasets.train2": ("ycbv_train_real",),
        "datasets.train2_ratio": 0.0,
        "datasets.test": ("ycbv_test",),
        "datasets.sym_objs": ("024_bowl", "036_wood_block", "051_large_clamp",
                              "052_extra_large_clamp", "061_foam_brick"),
        "val.dataset_name": "ycbv",
    })


def ycbv_convnext_base_rgbd() -> Config:
    return replace_cfg(Config(), {
        "output_dir": "output/gdrn/ycbv/convnext_base_rgbd",
        "exp_name": "gdrn_ycbv_convnext_base_rgbd",
        "model.pose_net.name": "gdrn_dstream_double_mask",
        "model.pose_net.fuse_type": "cat",
        "model.pose_net.num_classes": 21,
        "model.pose_net.backbone.name": "convnext_base",
        "model.bbox_type": "AMODAL_CLIP",
        "input.with_depth": True,
        "input.bp_depth": True,
        "input.depth_aug": True,
        "input.drop_depth_ratio": 0.2,
        "input.drop_depth_prob": 0.5,
        "input.add_noise_depth_level": 0.01,
        "input.add_noise_depth_prob": 0.9,
        "solver.ims_per_batch": 48,
        "solver.total_epochs": 40,
        "solver.base_lr": 8e-4,
        "solver.optimizer": "ranger",
        "solver.anneal_point": 0.72,
        "datasets.train": ("ycbv_train_pbr",),
        "datasets.train2": ("ycbv_train_real",),
        "datasets.train2_ratio": 0.0,
        "datasets.test": ("ycbv_test",),
        "datasets.sym_objs": ("024_bowl", "036_wood_block", "051_large_clamp",
                              "052_extra_large_clamp", "061_foam_brick"),
        "val.dataset_name": "ycbv",
        "val.use_depth_refine": True,
        "val.depth_refine_iters": 2,
    })
