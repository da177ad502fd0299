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

``<ds>_convnext_base`` for ``ds`` in lm, lmo, tless, tudl, icbin, itodd and
hb is the same recipe for that dataset, as ``configs/gdrn/<ds>_convnext_base.py``
sets it (its class count, train_pbr and test splits; no real train split and
no symmetric-object list). ``so(dataset, obj)`` is the per-object ("SO")
config of one object, as ``tools/gen_so_configs.py`` writes it into
``configs/gdrn/<dataset>SO/<obj>.py``: one class with class-agnostic heads.
It stands for that generated file tree. Like the JAX package, nothing reads
the files' ``SO_OBJECT`` / ``SO_OBJ_ID``: a per-object config serves and
trains on every object's records. ``GDRN_CONFIGS`` maps each recipe's name to
its function; ``tools/test_gdrn.py::load_config`` also takes
``<dataset>SO/<obj>``.

``yolox(name)`` is the BOP'22 yolox-x detector recipe ``name``, the port's
copy of ``configs/yolox/<name>.py`` (yolox-x at 640², TTA at scales 1, .75,
.83, 1.12, 1.25 with conf 0.001, NMS 0.65; ``YoloxConfig``'s defaults are
the shared recipe): a dataset's PBR-only recipe, or ``<dataset>_real_pbr``
with the real train split beside train_pbr.
"""

from __future__ import annotations

import functools

from .config import Config, YoloxConfig, replace_cfg
from .datasets.meta import get_meta

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


# the class counts of configs/gdrn/<ds>_convnext_base.py
_CORE_CLASSES = {"lm": 15, "lmo": 8, "tless": 30, "tudl": 3, "icbin": 2, "itodd": 28, "hb": 33}


def convnext_base_recipe(dataset: str) -> Config:
    """configs/gdrn/<dataset>_convnext_base.py for a core dataset other than ycbv."""
    return replace_cfg(Config(), {
        "output_dir": f"output/gdrn/{dataset}/convnext_base",
        "exp_name": f"gdrn_{dataset}_convnext_base",
        "model.pose_net.num_classes": _CORE_CLASSES[dataset],
        "model.pose_net.backbone.name": "convnext_base",
        "model.bbox_type": "AMODAL_CLIP",
        "solver.ims_per_batch": 48,
        "solver.total_epochs": 40,
        "solver.base_lr": 8e-4,
        "solver.optimizer": "ranger",
        "solver.anneal_point": 0.72,
        "datasets.train": (f"{dataset}_train_pbr",),
        "datasets.test": (f"{dataset}_test",),
        "val.dataset_name": dataset,
    })


GDRN_CONFIGS = {
    "ycbv_convnext_base": ycbv_convnext_base,
    "ycbv_convnext_base_rgbd": ycbv_convnext_base_rgbd,
    **{f"{ds}_convnext_base": functools.partial(convnext_base_recipe, ds) for ds in _CORE_CLASSES},
}


def so_objects(dataset: str) -> tuple:
    """The per-object config names of a dataset (object names, '-' as '_')."""
    meta = get_meta(dataset)
    return tuple(meta.id2obj[i].replace("-", "_") for i in sorted(meta.id2obj))


def so(dataset: str, obj: str) -> Config:
    """The per-object config of ``obj`` in ``dataset``, as
    tools/gen_so_configs.py writes configs/gdrn/<dataset>SO/<obj>.py."""
    meta = get_meta(dataset)
    if obj not in so_objects(dataset):
        raise ValueError(f"{obj!r} is not an object of {meta.name}: one of "
                         f"{', '.join(so_objects(dataset))}")
    return replace_cfg(Config(), {
        "output_dir": f"output/gdrn/{meta.name}SO/{obj}",
        "exp_name": f"gdrn_{meta.name}_{obj}",
        "model.pose_net.num_classes": 1,
        "model.pose_net.backbone.name": "convnext_base",
        "model.pose_net.geo_head.xyz_class_aware": False,
        "model.pose_net.geo_head.mask_class_aware": False,
        "model.pose_net.geo_head.region_class_aware": False,
        "model.bbox_type": "AMODAL_CLIP",
        "solver.ims_per_batch": 48,
        "solver.total_epochs": 40,
        "solver.base_lr": 8e-4,
        "datasets.train": (f"{meta.name}_train_pbr",),
        "datasets.test": (f"{meta.name}_test",),
        "val.dataset_name": meta.name,
    })
