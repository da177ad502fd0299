"""BOP-format IO: scene json files and the BOP19 result CSV.

Port of ``gdrnpp_bop2022_tpu/bop/inout.py`` (numpy host code, kept close
to verbatim; importing the JAX package's ``bop`` package would import jax).
The PLY reader arrives with the model banks of slice 2.
"""

from __future__ import annotations

import json

import numpy as np


# ---------------------------------------------------------------------------
# json
# ---------------------------------------------------------------------------

def load_json(path, keys_to_int: bool = False):
    with open(path, "r") as f:
        data = json.load(f)
    if keys_to_int and isinstance(data, dict):
        data = {int(k) if k.lstrip("-").isdigit() else k: v for k, v in data.items()}
    return data


def save_json(path, content):
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.integer,)):
            return int(o)
        raise TypeError(type(o))
    with open(path, "w") as f:
        json.dump(content, f, default=default)


def load_scene_camera(path):
    """scene_camera.json -> {im_id: {"cam_K": (3,3), "depth_scale": float, ...}}."""
    data = load_json(path, keys_to_int=True)
    out = {}
    for im_id, cam in data.items():
        c = dict(cam)
        if "cam_K" in c:
            c["cam_K"] = np.asarray(c["cam_K"], np.float64).reshape(3, 3)
        if "cam_R_w2c" in c:
            c["cam_R_w2c"] = np.asarray(c["cam_R_w2c"], np.float64).reshape(3, 3)
        if "cam_t_w2c" in c:
            c["cam_t_w2c"] = np.asarray(c["cam_t_w2c"], np.float64).reshape(3, 1)
        out[im_id] = c
    return out


def load_scene_gt(path):
    """scene_gt.json -> {im_id: [{"obj_id", "cam_R_m2c" (3,3), "cam_t_m2c" (3,1)}]}."""
    data = load_json(path, keys_to_int=True)
    out = {}
    for im_id, gts in data.items():
        lst = []
        for gt in gts:
            g = dict(gt)
            if "cam_R_m2c" in g:
                g["cam_R_m2c"] = np.asarray(g["cam_R_m2c"], np.float64).reshape(3, 3)
            if "cam_t_m2c" in g:
                g["cam_t_m2c"] = np.asarray(g["cam_t_m2c"], np.float64).reshape(3, 1)
            lst.append(g)
        out[im_id] = lst
    return out


def load_scene_gt_info(path):
    """scene_gt_info.json (bbox_obj, bbox_visib, visib_fract, px counts)."""
    return load_json(path, keys_to_int=True)


def load_test_targets(path):
    """test_targets_bop19.json: [{"im_id", "inst_count", "obj_id", "scene_id"}]."""
    return load_json(path)


# ---------------------------------------------------------------------------
# BOP19 results CSV
# ---------------------------------------------------------------------------

def save_bop_results(path, results, version: str = "bop19"):
    """results: list of dicts with scene_id, im_id, obj_id, score, R (3,3),
    t (3,) [mm], time (s). Writes the BOP19 CSV format
    (reference: inout.py:340, test_utils.py:37)."""
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for res in results:
        run_time = res.get("time", -1)
        R = np.asarray(res["R"], np.float64).reshape(9)
        t = np.asarray(res["t"], np.float64).reshape(3)
        lines.append(
            "{scene_id},{im_id},{obj_id},{score},{R},{t},{time}".format(
                scene_id=int(res["scene_id"]),
                im_id=int(res["im_id"]),
                obj_id=int(res["obj_id"]),
                score=float(res["score"]),
                R=" ".join(f"{v:.8f}" for v in R),
                t=" ".join(f"{v:.8f}" for v in t),
                time=run_time,
            )
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_bop_results(path, version: str = "bop19"):
    results = []
    with open(path, "r") as f:
        header = f.readline().strip()
        for line in f:
            line = line.strip()
            if not line:
                continue
            elems = line.split(",")
            results.append({
                "scene_id": int(elems[0]),
                "im_id": int(elems[1]),
                "obj_id": int(elems[2]),
                "score": float(elems[3]),
                "R": np.fromstring(elems[4], sep=" ").reshape(3, 3),
                "t": np.fromstring(elems[5], sep=" "),
                "time": float(elems[6]),
            })
    return results
