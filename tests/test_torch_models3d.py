"""Port parity: PLY reader, model bank and symmetries against the JAX package.

``load_ply`` and ``ModelBank.from_bop_models_dir`` run on the cube meshes of
tests/synth_utils.py and on a sphere above ``max_faces`` (so the
vertex-clustering decimation runs), in binary and ascii PLY; every array
they return equals the JAX package's. The symmetry enumeration equals
the JAX one; the sym bank and ``get_closest_rot_batch`` agree to fp32
rounding.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.bop.inout import load_ply as j_load_ply
from gdrnpp_bop2022_tpu.bop.inout import save_json
from gdrnpp_bop2022_tpu.bop.models3d import ModelBank as JBank
from gdrnpp_bop2022_tpu.geometry import symmetry as jsym
from gdrnpp_bop2022_torch.bop.inout import load_ply
from gdrnpp_bop2022_torch.bop.models3d import ModelBank, decimate_mesh
from gdrnpp_bop2022_torch.geometry import symmetry as tsym
from synth_utils import cube_ply


def _sphere(n_lat=16, n_lon=24, r=40.0):
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)), np.outer(np.sin(th), np.sin(ph)),
                     np.repeat(np.cos(th)[:, None], n_lon, 1)], -1).reshape(-1, 3)
    pts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * r
    faces = []
    for j in range(n_lon):
        k = (j + 1) % n_lon
        faces.append([0, 1 + j, 1 + k])
        for i in range(n_lat - 2):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + k
            faces += [[a, a + n_lon, b + n_lon], [a, b + n_lon, b]]
        last = 1 + (n_lat - 2) * n_lon
        faces.append([last + j, len(pts) - 1, last + k])
    return pts, np.asarray(faces)


def _write_ply(path, pts, faces, ascii=False):
    with open(path, "wb") as f:
        f.write((f"ply\nformat {'ascii' if ascii else 'binary_little_endian'} 1.0\n"
                 f"element vertex {len(pts)}\nproperty float x\nproperty float y\n"
                 f"property float z\nelement face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n").encode())
        if ascii:
            f.write("".join(f"{x} {y} {z}\n" for x, y, z in pts).encode())
            f.write("".join(f"3 {a} {b} {c}\n" for a, b, c in faces).encode())
        else:
            f.write(np.asarray(pts, "<f4").tobytes())
            rec = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", 3)])
            rec["n"], rec["i"] = 3, faces
            f.write(rec.tobytes())


_INFO = {
    1: {"diameter": 103.9, "min_x": -30, "min_y": -30, "min_z": -30,
        "size_x": 60, "size_y": 60, "size_z": 60,
        "symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]]},
    2: {"diameter": 80.0, "min_x": -40, "min_y": -40, "min_z": -40,
        "size_x": 80, "size_y": 80, "size_z": 80,
        "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 5]}]},
    3: {"diameter": 69.3, "min_x": -20, "min_y": -20, "min_z": -20,
        "size_x": 40, "size_y": 40, "size_z": 40},
}


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    cube_ply(os.path.join(d, "obj_000001.ply"), 30.0)
    pts, faces = _sphere()
    _write_ply(os.path.join(d, "obj_000002.ply"), pts, faces)
    _write_ply(os.path.join(d, "obj_000003.ply"), pts * 0.5, faces, ascii=True)
    save_json(os.path.join(d, "models_info.json"), {str(k): v for k, v in _INFO.items()})
    return str(d)


@pytest.mark.parametrize("oid", [1, 2, 3])
def test_load_ply_matches_jax(models_dir, oid):
    path = os.path.join(models_dir, f"obj_{oid:06d}.ply")
    want, got = j_load_ply(path, vertex_scale=1e-3), load_ply(path, vertex_scale=1e-3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_ply_rejects_other_files(tmp_path):
    p = tmp_path / "x.ply"
    p.write_bytes(b"not a mesh\n")
    with pytest.raises(ValueError, match="not a ply"):
        load_ply(str(p))


@pytest.mark.parametrize("max_faces", [4096, 300])
def test_model_bank_matches_jax(models_dir, max_faces):
    kw = dict(max_faces=max_faces, num_points=64, num_fps=8, max_sym_disc_step=0.5)
    want = JBank.from_bop_models_dir(models_dir, **kw)
    got = ModelBank.from_bop_models_dir(models_dir, **kw)
    if max_faces == 300:    # the 720-face spheres were decimated
        assert want.faces.shape[1] <= 300
    for k in ("verts", "faces", "points", "fps_points", "extents", "diameters", "centers"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.obj_ids == want.obj_ids == [1, 2, 3]
    for a, b in zip(got.sym_rotations + got.sym_translations,
                    want.sym_rotations + want.sym_translations):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    bank, mask = got.sym_bank()
    jb, jm = want.sym_bank()
    assert isinstance(bank, torch.Tensor) and bank.dtype == torch.float32
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


def test_decimate_mesh_keeps_small_meshes():
    pts, faces = _sphere(6, 8)
    p2, f2 = decimate_mesh(pts, faces, 1000)
    assert p2 is pts and f2 is faces


def test_symmetry_enumeration_matches_jax():
    for oid in (1, 2, 3):
        for step in (0.01, 0.3):
            want = jsym.get_symmetry_transformations(_INFO[oid], step)
            got = tsym.get_symmetry_transformations(_INFO[oid], step)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["R"], b["R"])
                np.testing.assert_array_equal(a["t"], b["t"])
        np.testing.assert_array_equal(tsym.get_symmetry_rotations(_INFO[oid], 0.3),
                                      jsym.get_symmetry_rotations(_INFO[oid], 0.3))


def test_closest_rot_batch_matches_jax():
    rs = np.random.RandomState(0)
    per_class = [tsym.get_symmetry_rotations(_INFO[1]),
                 tsym.get_symmetry_rotations(_INFO[2], 0.2), None]
    bank, mask = tsym.build_sym_bank(per_class)
    jb, jm = jsym.build_sym_bank(per_class)
    np.testing.assert_array_equal(bank.numpy(), np.asarray(jb))

    def rot(n):
        q = np.stack([np.linalg.qr(rs.randn(3, 3))[0] for _ in range(n)])
        q[np.linalg.det(q) < 0, :, 0] *= -1
        return q.astype(np.float32)

    pred, gt = rot(9), rot(9)
    labels = np.array([0, 1, 2] * 3, np.int32)
    want = np.asarray(jsym.get_closest_rot_batch(
        jnp.asarray(pred), jnp.asarray(gt), jb, jm, jnp.asarray(labels)))
    got = tsym.get_closest_rot_batch(torch.from_numpy(pred), torch.from_numpy(gt),
                                     bank, mask, torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[2::3], gt[2::3], atol=1e-6)   # no symmetry
