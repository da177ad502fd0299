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

``yolox(name)`` is the BOP'22 yolox-x detector recipe ``name``, the port's
copy of ``configs/yolox/<name>.py`` (yolox-x at 640², TTA at scales 1, .75,
.83, 1.12, 1.25 with conf 0.001, NMS 0.65; ``YoloxConfig``'s defaults are
the shared recipe): a dataset's PBR-only recipe, or ``<dataset>_real_pbr``
with the real train split beside train_pbr.
"""

from __future__ import annotations

from .config import Config, YoloxConfig, replace_cfg

# the detector recipes' datasets, and the real train split of those with a
# real+PBR recipe (configs/yolox/*_real_pbr.py)
YOLOX_DATASETS = ("ycbv", "lmo", "tless", "tudl", "icbin", "itodd", "hb")
_YOLOX_REAL_SPLIT = {"ycbv": "train_real", "tless": "train_primesense", "tudl": "train_real"}
YOLOX_RECIPES = YOLOX_DATASETS + tuple(f"{d}_real_pbr" for d in _YOLOX_REAL_SPLIT)


def yolox(name: str) -> YoloxConfig:
    if name not in YOLOX_RECIPES:
        raise ValueError(f"yolox recipe {name!r}: one of {', '.join(YOLOX_RECIPES)}")
    dataset = name.removesuffix("_real_pbr")
    cfg = YoloxConfig(dataset=dataset, output_dir=f"output/yolox/{dataset}")
    if name.endswith("_real_pbr"):
        cfg = replace_cfg(cfg, {"train_splits": ("train_pbr", _YOLOX_REAL_SPLIT[dataset])})
    return cfg


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
