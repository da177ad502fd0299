"""Per-dataset BOP metadata (the reference's ``ref/`` package as data).

Port of ``gdrnpp_bop2022_tpu/datasets/meta.py`` (verbatim; importing the
JAX package's ``datasets`` package would import jax).

One declarative registry instead of eight near-identical python modules
(reference: ref/ycbv.py, ref/lm_full.py, ref/lmo_full.py, ref/tless.py,
ref/tudl.py, ref/icbin.py, ref/itodd.py, ref/hb.py). Values are BOP-dataset
facts: object id->name maps, default camera intrinsics, image sizes, depth
scale factors, the objects treated as symmetric by the custom evaluator
(reference: configs/gdrn/ycbv/...ycbv.py:50-56 SYM_OBJS).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetMeta:
    name: str
    id2obj: Dict[int, str]
    width: int
    height: int
    camera_matrix: np.ndarray
    depth_factor: float = 1000.0
    sym_objs: Tuple[str, ...] = ()
    vertex_scale: float = 0.001
    train_pbr_scenes: Optional[Sequence[int]] = None
    test_scenes: Optional[Sequence[int]] = None
    # BOP eval parameterization (reference eval matrix,
    # lib/pysixd/scripts/eval_pose_results_more.py:41-83): vsd_delta is
    # 15mm for every dataset EXCEPT itodd (5mm); n_top -1 = score all
    # estimates per target; visib_gt_min filters GT below 10% visibility
    vsd_delta: float = 0.015
    eval_n_top: int = -1
    visib_gt_min: float = 0.1

    @property
    def objects(self):
        return list(self.id2obj.values())

    @property
    def obj2id(self):
        return {v: k for k, v in self.id2obj.items()}

    @property
    def num_classes(self):
        return len(self.id2obj)

    def obj_ids(self):
        return sorted(self.id2obj.keys())

    def label_to_obj_id(self):
        """contiguous 0-based label -> BOP obj id."""
        return {i: oid for i, oid in enumerate(self.obj_ids())}

    def obj_id_to_label(self):
        return {oid: i for i, oid in enumerate(self.obj_ids())}

    def models_dir(self, root: str, kind: str = "models") -> str:
        return os.path.join(root, self.name, kind)


def _K(fx, skew, cx, fy, cy):
    return np.array([[fx, skew, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


_LM_OBJECTS = {
    1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "can", 6: "cat",
    7: "cup", 8: "driller", 9: "duck", 10: "eggbox", 11: "glue",
    12: "holepuncher", 13: "iron", 14: "lamp", 15: "phone",
}

DATASETS_META: Dict[str, DatasetMeta] = {}


def _register(meta: DatasetMeta):
    DATASETS_META[meta.name] = meta
    return meta


_register(DatasetMeta(
    name="ycbv",
    id2obj={
        1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
        4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
        7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
        10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
        13: "024_bowl", 14: "025_mug", 15: "035_power_drill",
        16: "036_wood_block", 17: "037_scissors", 18: "040_large_marker",
        19: "051_large_clamp", 20: "052_extra_large_clamp", 21: "061_foam_brick",
    },
    width=640, height=480,
    camera_matrix=_K(1066.778, 0.0, 312.9869, 1067.487, 241.3109),
    depth_factor=10000.0,
    sym_objs=("024_bowl", "036_wood_block", "051_large_clamp",
              "052_extra_large_clamp", "061_foam_brick"),
    train_pbr_scenes=tuple(range(50)),
    test_scenes=tuple(range(48, 60)),
))

_register(DatasetMeta(
    name="lm", id2obj=dict(_LM_OBJECTS), width=640, height=480,
    camera_matrix=_K(572.4114, 0.0, 325.2611, 573.57043, 242.04899),
    depth_factor=1000.0, sym_objs=("eggbox", "glue"),
))

_register(DatasetMeta(
    name="lmo",
    id2obj={k: v for k, v in _LM_OBJECTS.items()
            if k in (1, 5, 6, 8, 9, 10, 11, 12)},
    width=640, height=480,
    camera_matrix=_K(572.4114, 0.0, 325.2611, 573.57043, 242.04899),
    depth_factor=1000.0, sym_objs=("eggbox", "glue"),
    train_pbr_scenes=tuple(range(50)), test_scenes=(2,),
))

_register(DatasetMeta(
    name="tless", id2obj={i: str(i) for i in range(1, 31)},
    width=720, height=540,
    camera_matrix=_K(1075.65091572, 0.0, 360.0, 1073.90347929, 270.0),
    depth_factor=1000.0,
    sym_objs=tuple(str(i) for i in range(1, 31)),  # all tless objs treated sym
    train_pbr_scenes=tuple(range(50)), test_scenes=tuple(range(1, 21)),
))

_register(DatasetMeta(
    name="tudl", id2obj={1: "dragon", 2: "frog", 3: "can"},
    width=640, height=480,
    camera_matrix=_K(515.0, 0.0, 321.566, 515.0, 214.08),
    depth_factor=1000.0,
    train_pbr_scenes=tuple(range(50)), test_scenes=(1, 2, 3),
))

_register(DatasetMeta(
    name="icbin", id2obj={1: "coffee_cup", 2: "juice_carton"},
    width=640, height=480,
    camera_matrix=_K(550.0, 0.0, 316.0, 540.0, 244.0),
    depth_factor=1000.0,
    train_pbr_scenes=tuple(range(50)), test_scenes=(1, 2, 3),
))

_register(DatasetMeta(
    name="itodd", id2obj={i: str(i) for i in range(1, 29)},
    width=1280, height=960,
    camera_matrix=_K(2992.63, 0.0, 633.886, 3003.99, 489.554),
    depth_factor=1000.0,
    train_pbr_scenes=tuple(range(50)), test_scenes=(1,),
    vsd_delta=0.005,   # eval_pose_results_more.py:46 — "itodd": 5 (mm)
))

_register(DatasetMeta(
    name="hb",
    id2obj={
        1: "01_bear", 2: "02_benchvise", 3: "03_round_car", 4: "04_thin_cow",
        5: "05_fat_cow", 6: "06_mug", 7: "07_driller", 8: "08_green_rabbit",
        9: "09_holepuncher", 10: "10", 11: "11", 12: "12", 13: "13", 14: "14",
        15: "15", 16: "16", 17: "17", 18: "18_jaffa_cakes_box", 19: "19_minions",
        20: "20_color_dog", 21: "21_phone", 22: "22_rhinoceros", 23: "23_dog",
        24: "24", 25: "25_car", 26: "26_motorcycle", 27: "27_high_heels",
        28: "28_stegosaurus", 29: "29_tea_box", 30: "30_triceratops",
        31: "31_toy_baby", 32: "32_car", 33: "33_yellow_rabbit",
    },
    width=640, height=480,
    camera_matrix=_K(537.4799, 0.0, 318.8965, 536.1447, 238.3781),
    depth_factor=1000.0,
    train_pbr_scenes=tuple(range(50)), test_scenes=(3, 5, 13),
))


def register_meta(meta: DatasetMeta) -> DatasetMeta:
    """Register a custom dataset (user datasets / tests). Reference
    analogue: the per-dataset register_with_name_cfg + DatasetCatalog
    machinery (core/gdrn_modeling/datasets/dataset_factory.py)."""
    return _register(meta)


def get_meta(name: str) -> DatasetMeta:
    key = name.split("_")[0]
    if key not in DATASETS_META:
        raise KeyError(f"unknown dataset: {name} (known: {sorted(DATASETS_META)})")
    return DATASETS_META[key]
