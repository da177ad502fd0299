"""BOP-format IO: scene json files and the BOP19 result CSV.

Port of ``gdrnpp_bop2022_tpu/bop/inout.py`` (numpy host code, kept close
to verbatim; importing the JAX package's ``bop`` package would import jax):
scene json files, the BOP19 result CSV and the PLY mesh reader.
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


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("i1", 1), "uchar": ("u1", 1), "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4), "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8), "float64": ("f8", 8),
    "int8": ("i1", 1), "uint8": ("u1", 1), "int16": ("i2", 2), "uint16": ("u2", 2),
}


def load_ply(path, vertex_scale: float = 1.0):
    """Load a (possibly binary) triangular PLY mesh.

    Returns dict with 'pts' (n,3); optional 'normals', 'colors' (n,3 uint8),
    'texture_uv' (n,2), 'faces' (m,3 int); 'texture_file' if referenced —
    the same contract as the reference loader (inout.py:489).
    """
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().decode("ascii", "ignore").strip()
        if line != "ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        n_verts = n_faces = 0
        vert_props = []       # (name, dtype_code)
        face_props = []
        texture_file = None
        section = None
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("comment"):
                if "TextureFile" in line:
                    texture_file = line.split()[-1]
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_verts = int(line.split()[-1])
                section = "vertex"
            elif line.startswith("element face"):
                n_faces = int(line.split()[-1])
                section = "face"
            elif line.startswith("element"):
                section = "other"
            elif line.startswith("property"):
                parts = line.split()
                if section == "vertex":
                    vert_props.append((parts[-1], parts[1]))
                elif section == "face":
                    if parts[1] == "list":
                        face_props.append((parts[-1], "list", parts[2], parts[3]))
                    else:
                        face_props.append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        model = {}
        prop_names = [p[0] for p in vert_props]

        if fmt == "ascii":
            vert_data = np.loadtxt(
                [f.readline() for _ in range(n_verts)], dtype=np.float64, ndmin=2)
            faces = []
            for _ in range(n_faces):
                vals = f.readline().split()
                cnt = int(vals[0])
                if cnt != 3:
                    raise ValueError(f"{path}: only triangular faces supported")
                faces.append([int(v) for v in vals[1:4]])
            faces = np.asarray(faces, np.int64) if n_faces else None
        else:
            little = fmt == "binary_little_endian"
            order = "<" if little else ">"
            dtype = np.dtype([(name, order + _PLY_TYPES[t][0])
                              for name, t in vert_props])
            vert_raw = np.frombuffer(f.read(dtype.itemsize * n_verts),
                                     dtype=dtype, count=n_verts)
            vert_data = np.stack(
                [vert_raw[name].astype(np.float64) for name in prop_names], axis=1)
            faces = None
            if n_faces:
                # assume the standard uchar count + int indices layout,
                # possibly followed by texcoord list floats
                fl = []
                has_uv_face = any(p[0] == "texcoord" for p in face_props)
                cdt = np.dtype(order + "u1")
                idt = None
                for p in face_props:
                    if len(p) == 4 and p[0] in ("vertex_indices", "vertex_index"):
                        cdt = np.dtype(order + _PLY_TYPES[p[2]][0])
                        idt = np.dtype(order + _PLY_TYPES[p[3]][0])
                uv_faces = []
                for _ in range(n_faces):
                    cnt = int(np.frombuffer(f.read(cdt.itemsize), dtype=cdt)[0])
                    if cnt != 3:
                        raise ValueError(f"{path}: only triangular faces supported")
                    fl.append(np.frombuffer(f.read(3 * idt.itemsize), dtype=idt))
                    if has_uv_face:
                        uc = int(np.frombuffer(f.read(1), dtype=np.uint8)[0])
                        uv_faces.append(np.frombuffer(f.read(4 * uc), dtype=order + "f4"))
                faces = np.stack(fl).astype(np.int64)
                if uv_faces:
                    model["texture_uv_face"] = np.stack(uv_faces)

        def col(names):
            idx = [prop_names.index(n) for n in names]
            return vert_data[:, idx]

        model["pts"] = col(["x", "y", "z"]) * vertex_scale
        if all(n in prop_names for n in ("nx", "ny", "nz")):
            model["normals"] = col(["nx", "ny", "nz"])
        if all(n in prop_names for n in ("red", "green", "blue")):
            model["colors"] = col(["red", "green", "blue"]).astype(np.uint8)
        if all(n in prop_names for n in ("texture_u", "texture_v")):
            model["texture_uv"] = col(["texture_u", "texture_v"])
        if faces is not None:
            model["faces"] = faces
        if texture_file is not None:
            model["texture_file"] = texture_file
        return model
