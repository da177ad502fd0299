"""Port parity: the rasterizer (kernel B2's plain version) against the JAX package.

The port's plain rasterizer is held against the XLA scan
``render_depth_xyz_batch`` and the Pallas kernel
``render_depth_xyz_pallas(interpret=True)`` on the fixtures of
tests/test_pallas_raster.py (cubes at 64x64, a ragged 54x72 image, the
depth-only mode), at that file's tolerances: identical silhouettes, depth
within 1e-5, xyz within 1e-4 where hit. ``_pack_face_data`` agrees with the
JAX one to fp32 rounding on the same camera-space vertices.

The kernel's cull rule ``face_screen_boxes`` is checked here on
adversarial faces (slivers, edges through pixel centres, faces across
x, y = 16 k, vertices just above z = 1e-6, faces outside the image,
padding faces, large faces): every pixel that the plain version's inside
test accepts lies in its face's box. ``face_major`` (the pack kernel's
layout) round-trips to ``_pack_face_data``'s rows.

The CUDA kernels run only on the card: the ``gpu`` tests at the end
compare them with the plain version there (the packing and the boxes bit
for bit, the renders on the cubes and on the adversarial faces) and skip
on a machine without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops.pallas_raster import _pack_face_data as j_pack
from gdrnpp_bop2022_tpu.ops.pallas_raster import render_depth_xyz_pallas
from gdrnpp_bop2022_tpu.ops.rasterizer import render_depth_xyz_batch as j_render
from gdrnpp_bop2022_torch.ops.raster import (PACKED_COLS, _pack_face_data, face_major,
                                             face_screen_boxes, pack_faces_cuda,
                                             render_depth_xyz_cuda, transform_verts)
from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz, render_depth_xyz_batch
from gdrnpp_bop2022_torch.utils import cuda_build
from test_pallas_raster import _cubes


def _ragged_cubes():
    rs = np.random.RandomState(7)
    verts, faces, Q, t, _ = _cubes(2, rs)
    K = np.tile(np.array([[450.0, 0, 36.0], [0, 450.0, 27.0], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    return verts, faces, Q, t, K


def _cases():
    return {"cubes_64x64": (_cubes(3, np.random.RandomState(0)), 64, 64),
            "ragged_54x72": (_ragged_cubes(), 54, 72)}


def _assert_same_render(d, x, d_ref, x_ref):
    np.testing.assert_array_equal(d > 0, d_ref > 0)          # silhouettes
    hit = d_ref > 0
    assert hit.any()
    np.testing.assert_allclose(d[hit], d_ref[hit], atol=1e-5)
    if x is not None:
        np.testing.assert_allclose(x[hit], x_ref[hit], atol=1e-4)
        assert (x[~hit] == 0).all()
    assert (d[~hit] == 0).all()


@pytest.mark.parametrize("case", ["cubes_64x64", "ragged_54x72"])
@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_matches_jax(case, oracle):
    arrays, H, W = _cases()[case]
    if oracle == "xla":
        d_ref, x_ref = j_render(*(jnp.asarray(a) for a in arrays), H, W)
    else:
        d_ref, x_ref = render_depth_xyz_pallas(*(jnp.asarray(a) for a in arrays), H, W,
                                               tile_p=1024, tile_f=128, interpret=True)
    d, x = render_depth_xyz_batch(*(torch.from_numpy(a) for a in arrays), H, W)
    assert d.shape == (arrays[0].shape[0], H, W) and x.shape == d.shape + (3,)
    _assert_same_render(d.numpy(), x.numpy(), np.asarray(d_ref), np.asarray(x_ref))


@pytest.mark.parametrize("case", ["cubes_64x64", "ragged_54x72"])
@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_depth_only_matches_jax(case, oracle):
    arrays, H, W = _cases()[case]
    ja = [jnp.asarray(a) for a in arrays]
    if oracle == "xla":              # the XLA scan renders both; its depth is the oracle
        d_ref, _ = j_render(*ja, H, W)
    else:
        d_ref, _ = render_depth_xyz_pallas(*ja, H, W, tile_p=1024, tile_f=128,
                                           interpret=True, with_attrs=False)
    d, x = render_depth_xyz_batch(*(torch.from_numpy(a) for a in arrays), H, W,
                                  need_xyz=False)
    assert x is None and d.shape == (arrays[0].shape[0], H, W)
    _assert_same_render(d.numpy(), None, np.asarray(d_ref), None)


def test_depth_only_is_bit_equal_to_full_and_to_pallas():
    arrays = _cubes(2, np.random.RandomState(11))
    ta = [torch.from_numpy(a) for a in arrays]
    d_full, _ = render_depth_xyz_batch(*ta, 64, 64)
    d_only, x_none = render_depth_xyz_batch(*ta, 64, 64, need_xyz=False)
    assert x_none is None
    assert torch.equal(d_only, d_full)
    d_pl, _ = render_depth_xyz_pallas(*(jnp.asarray(a) for a in arrays), 64, 64,
                                      tile_p=1024, tile_f=128, interpret=True,
                                      with_attrs=False)
    _assert_same_render(d_only.numpy(), None, np.asarray(d_pl), None)


@pytest.mark.parametrize("with_attrs", [True, False])
def test_pack_face_data_matches_jax(with_attrs):
    verts, faces, Q, t, K = _ragged_cubes()
    faces = np.concatenate([faces, np.zeros((2, 5, 3), np.int32)], 1)   # padding faces
    K[:, 0, 1] = 3.0                                                     # skew
    verts_cam = (np.einsum("bij,bvj->bvi", Q, verts) + t[:, None]).astype(np.float32)
    want = np.asarray(j_pack(jnp.asarray(verts_cam), jnp.asarray(verts),
                             jnp.asarray(faces), jnp.asarray(K), with_attrs))
    got = _pack_face_data(torch.from_numpy(verts_cam), torch.from_numpy(verts),
                          torch.from_numpy(faces), torch.from_numpy(K), with_attrs)
    assert got.shape == want.shape == (2, 20 if with_attrs else 11, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got[:, 9, 12:] == 0).all() and (got[:, 10, 12:] == 0).all()   # invalid


@pytest.mark.parametrize("with_attrs", [True, False])
def test_face_major_round_trips_to_rows(with_attrs):
    verts, faces, Q, t, K = _ragged_cubes()
    faces = np.concatenate([faces, np.zeros((2, 3, 3), np.int32)], 1)
    ta = [torch.from_numpy(a) for a in (verts, faces, Q, t, K)]
    fd = _pack_face_data(transform_verts(ta[0], ta[2], ta[3]), ta[0], ta[1], ta[4],
                         with_attrs)
    fm = face_major(fd)
    n_rows = 20 if with_attrs else 11
    assert fm.shape == (2, 15, PACKED_COLS[with_attrs]) and fm.shape[-1] % 4 == 0
    back = torch.cat([fm[..., :11], fm[..., 12:12 + n_rows - 11]], -1).transpose(1, 2)
    assert torch.equal(back, fd)
    pad = [c for c in range(fm.shape[-1]) if c == 11 or c >= 12 + n_rows - 11]
    assert (fm[..., pad] == 0).all()


# ---------------------------------------------------------------------------
# the cull rule on adversarial faces
# ---------------------------------------------------------------------------

_F_PX = 512.0          # focal length; with z = 0.5 a pixel is 1/1024 m: exact in fp32
_Z_FLAT = 0.5
_ADVERSARIAL = ("slivers", "centre_edges", "tile_borders", "near_plane", "outside",
                "padding", "large")


def _cam(uv, z):
    """Camera-space points (N, 3) that project to pixel coords uv (N, 2) at
    depth z (N,) with K = diag(_F_PX, _F_PX, 1) (principal point 0)."""
    return np.concatenate([uv * (z / _F_PX)[:, None], z[:, None]], 1)


def _adversarial(kind, rs, H, W):
    """(verts_cam (V, 3), faces (F, 3)) of one kind of adversarial face."""
    if kind == "slivers":          # a third vertex 1e-6..1e-1 px off the other two's segment
        n = 96
        a, b = rs.uniform(-8, [W + 8, H + 8], (2, n, 2))
        d = b - a
        nrm = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1, keepdims=True)
        c = a + rs.uniform(0, 1, (n, 1)) * d + nrm * 10.0 ** rs.uniform(-6, -1, (n, 1))
        uv = np.stack([a, b, c], 1).reshape(-1, 2)
        z = rs.uniform(0.4, 2.0, len(uv))
    elif kind == "centre_edges":   # integer vertices: edges through pixel centres
        n = 96
        a = rs.randint(-2, [W + 2, H + 2], (n, 2))
        uv = np.stack([a, a + rs.randint(-9, 10, (n, 2)), a + rs.randint(-9, 10, (n, 2))],
                      1).reshape(-1, 2).astype(np.float64)
        z = np.full(len(uv), _Z_FLAT)
    elif kind == "tile_borders":   # small faces across x, y = 16 k, on and off centres
        n = 96
        grid = np.array([15.0, 15.5, 16.0, 16.5, 17.0])
        base = rs.choice([0, 16, 32, 48], (n, 1, 2)) + rs.choice(grid, (n, 3, 2)) - 16
        uv = np.clip(base + rs.choice([0, 16], (n, 1, 2)), -1, max(H, W)).reshape(-1, 2)
        z = np.where(rs.rand(len(uv)) < 0.5, _Z_FLAT, rs.uniform(0.4, 2.0, len(uv)))
    elif kind == "near_plane":     # a vertex 0.1-30 mm off axis at z just above 1e-6
        n = 48
        p = _cam(rs.uniform(-4, [W + 4, H + 4], (n * 3, 2)), rs.uniform(0.5, 1.5, n * 3))
        p[::3, :2] = rs.uniform(-3e-2, 3e-2, (n, 2)) * 10.0 ** rs.uniform(-2, 0, (n, 1))
        p[::3, 2] = rs.choice([1.0000001e-6, 1.5e-6, 2e-6, 1e-5, 1e-4, 1e-3], n)
        return p, np.arange(len(p)).reshape(-1, 3)
    elif kind == "outside":        # wholly outside, or just across the border
        n = 96
        side = rs.randint(0, 4, n)
        off = rs.uniform(0.2, 30, n)
        ctr = rs.uniform(0, [W, H], (n, 2))
        ctr[side == 0, 0] = -off[side == 0]
        ctr[side == 1, 0] = W - 1 + off[side == 1]
        ctr[side == 2, 1] = -off[side == 2]
        ctr[side == 3, 1] = H - 1 + off[side == 3]
        uv = (ctr[:, None] + rs.uniform(-1.5, 1.5, (n, 3, 2))).reshape(-1, 2)
        z = rs.uniform(0.4, 2.0, len(uv))
    elif kind == "padding":        # the bank's (0, 0, 0) faces, and a face behind the camera
        p = _cam(rs.uniform(0, [W, H], (6, 2)), np.array([0.5, 0.6, 0.7, -0.5, 0.6, 0.7]))
        return p, np.array([[0, 0, 0]] * 8 + [[0, 1, 2], [3, 4, 5], [1, 1, 2]])
    else:                          # large: extents of 1e2..1e5 px across the image
        n = 48
        ctr = rs.uniform(0, [W, H], (n, 1, 2))
        uv = (ctr + rs.uniform(-1, 1, (n, 3, 2)) * 10.0 ** rs.uniform(2, 5, (n, 1, 1))
              ).reshape(-1, 2)
        z = rs.uniform(0.4, 2.0, len(uv))
    p = _cam(uv, z)
    return p, np.arange(len(p)).reshape(-1, 3)


def _adversarial_batch(kinds, seed, H, W):
    """Arrays (verts, faces, R = I, t = 0, K) with one ROI per kind, padded
    to a common face count with (0, 0, 0) faces; K has a skew on odd ROIs."""
    rs = np.random.RandomState(seed)
    meshes = [_adversarial(k, rs, H, W) for k in kinds]
    V = max(len(p) for p, _ in meshes)
    F = max(len(f) for _, f in meshes)
    verts = np.zeros((len(kinds), V, 3), np.float32)
    faces = np.zeros((len(kinds), F, 3), np.int32)
    for i, (p, f) in enumerate(meshes):
        verts[i, :len(p)], faces[i, :len(f)] = p, f
    K = np.tile(np.diag([_F_PX, _F_PX, 1.0]).astype(np.float32), (len(kinds), 1, 1))
    K[1::2, 0, 1] = 2.0
    R = np.tile(np.eye(3, dtype=np.float32), (len(kinds), 1, 1))
    return verts, faces, R, np.zeros((len(kinds), 3), np.float32), K


def _accepted(fd, H, W):
    """(B, F, H, W) bool: the plain version's inside test (every
    barycentric >= -1e-5, valid face) at each pixel centre, written as in
    ops/rasterizer.py::render_depth_xyz_batch."""
    ey = torch.arange(H, dtype=torch.float32)[None, None, :, None]
    ex = torch.arange(W, dtype=torch.float32)[None, None, None, :]
    x0, y0, x1, y1, x2, y2, _, _, _, valid, inv_area = (fd[:, r, :, None, None]
                                                        for r in range(11))
    w0 = ((x1 - ex) * (y2 - ey) - (x2 - ex) * (y1 - ey)) * inv_area
    w1 = ((x2 - ex) * (y0 - ey) - (x0 - ex) * (y2 - ey)) * inv_area
    w2 = 1.0 - w0 - w1
    return (w0 >= -1e-5) & (w1 >= -1e-5) & (w2 >= -1e-5) & (valid > 0.5)


def _in_boxes(boxes, H, W):
    ey = torch.arange(H)[None, None, :, None]
    ex = torch.arange(W)[None, None, None, :]
    b = boxes.long()[..., None, None]
    return (ex >= b[:, :, 0]) & (ex <= b[:, :, 2]) & (ey >= b[:, :, 1]) & (ey <= b[:, :, 3])


@pytest.mark.parametrize("kind", _ADVERSARIAL)
@pytest.mark.parametrize("H,W", [(64, 64), (54, 72)])
def test_screen_boxes_hold_every_accepted_pixel(kind, H, W):
    verts, faces, R, t, K = (torch.from_numpy(a) for a in
                             _adversarial_batch([kind, kind], _ADVERSARIAL.index(kind), H, W))
    fd = _pack_face_data(transform_verts(verts, R, t), verts, faces, K, with_attrs=False)
    boxes = face_screen_boxes(fd, H, W)
    assert boxes.shape == (2, faces.shape[1], 4) and boxes.dtype == torch.int32
    acc = _accepted(fd, H, W)
    missed = acc & ~_in_boxes(boxes, H, W)
    assert not missed.any(), f"{int(missed.sum())} accepted pixels outside their face's box"
    if kind not in ("padding", "outside"):
        assert acc.any()                                   # the scene does reach the image
    empty = (boxes[..., 0] == 0) & (boxes[..., 1] == 0) & (boxes[..., 2] == -1) & (
        boxes[..., 3] == -1)
    assert torch.equal(empty | (fd[:, 9] > 0.5), torch.ones_like(empty))   # invalid -> empty
    lo_ok = (boxes[..., 0] >= 0) & (boxes[..., 1] >= 0)
    hi_ok = (boxes[..., 2] <= W - 1) & (boxes[..., 3] <= H - 1)
    assert (lo_ok & hi_ok).all()                            # clamped to the image


def test_screen_boxes_special_faces():
    """Tight around a small face; the whole image near the z = 1e-6
    plane; empty for a face wholly outside and for the padding."""
    H, W = 40, 48
    uv = np.array([[10.2, 5.5], [13.9, 7.0], [11.0, 9.25],          # small face
                   [5.0, 5.0], [30.0, 6.0], [8.0, 30.0],            # near the z plane
                   [-9.0, 3.0], [-4.0, 8.0], [-7.0, 12.0]])         # left of the image
    z = np.array([0.5, 0.5, 0.5, 0.7, 0.7, 0.9, 0.6, 0.6, 0.6])
    p = _cam(uv, z)
    p[3] = [0.01, 0.02, 1.5e-6]                                      # u, v ~ 3e6, 7e6 px
    verts = torch.from_numpy(p.astype(np.float32))[None]
    faces = torch.tensor([[[0, 1, 2], [3, 4, 5], [6, 7, 8], [0, 0, 0]]], dtype=torch.int32)
    K = torch.from_numpy(np.diag([_F_PX, _F_PX, 1.0]).astype(np.float32))[None]
    fd = _pack_face_data(verts, verts, faces, K, with_attrs=False)
    boxes = face_screen_boxes(fd, H, W)[0].tolist()
    assert boxes[0] == [9, 4, 15, 11]    # floor(10.2 - m), ceil(13.9 + m), m = 1.0007
    assert boxes[1] == [0, 0, W - 1, H - 1]
    assert boxes[2] == [0, 0, -1, -1]
    assert boxes[3] == [0, 0, -1, -1]


def test_chunking_does_not_change_the_result():
    """Small ROI/pixel/face blocks (many chunks, ragged ones included)
    give the same maps as one block: the first face still wins a tie."""
    rs = np.random.RandomState(3)
    verts, faces, Q, t, K = _cubes(3, rs)
    # a second, overlapping copy of each cube: exact ties on every pixel
    faces = np.concatenate([faces, faces, np.zeros((3, 3, 3), np.int32)], 1)
    ta = [torch.from_numpy(a) for a in (verts, faces, Q, t, K)]
    d1, x1 = render_depth_xyz_batch(*ta, 40, 36)
    d2, x2 = render_depth_xyz_batch(*ta, 40, 36, chunk=5, max_block=5 * 7)
    assert torch.equal(d1, d2) and torch.equal(x1, x2)
    assert (d1 > 0).any()


def test_dispatcher_runs_the_plain_version_on_cpu():
    arrays, H, W = _cases()["ragged_54x72"]
    ta = [torch.from_numpy(a) for a in arrays]
    before = render_depth_xyz_cuda.launches
    d, x = render_depth_xyz(*ta, H, W, need_xyz=False)
    assert x is None
    assert torch.equal(d, render_depth_xyz_batch(*ta, H, W, need_xyz=False)[0])
    assert render_depth_xyz_cuda.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        render_depth_xyz(*(a.to("meta") for a in ta), H, W)
    with pytest.raises(ValueError, match="CUDA tensors"):
        render_depth_xyz_cuda(*ta, H, W)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pack_faces_cuda(*ta, H, W)


def test_nvcc_command_builds_raster_without_fma(tmp_path, monkeypatch):
    cmd = cuda_build.nvcc_command("nvcc", cuda_build.CSRC / "raster.cu", tmp_path / "r.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert cmd[-1].endswith("raster.cu") and cmd[-3:-1] == ["-o", str(tmp_path / "r.so")]
    ln = cuda_build.nvcc_command("nvcc", cuda_build.CSRC / "layer_norm.cu", tmp_path / "l.so")
    assert "-fmad=false" not in ln
    # the per-kernel flags are part of the build's hash key
    key = cuda_build.library_path("raster")
    monkeypatch.setitem(cuda_build.EXTRA_FLAGS, "raster", ())
    assert cuda_build.library_path("raster") != key
    assert (cuda_build.CSRC / "raster.cu").read_text().count('extern "C"') == 1
    assert {"-prec-div=true", "-ftz=false"} <= set(cmd)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the B2 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cubes_64x64", "ragged_54x72"])
def test_kernel_matches_plain_on_card(case):
    dev = _cuda_or_skip()
    arrays, H, W = _cases()[case]
    ta = [torch.from_numpy(a).to(dev) for a in arrays]
    before = render_depth_xyz_cuda.launches
    d, x = render_depth_xyz_cuda(*ta, H, W)
    d_only, _ = render_depth_xyz_cuda(*ta, H, W, need_xyz=False)
    torch.cuda.synchronize()
    assert render_depth_xyz_cuda.launches == before + 2
    d_ref, x_ref = render_depth_xyz_batch(*ta, H, W)
    _assert_same_render(d.cpu().numpy(), x.cpu().numpy(), d_ref.cpu().numpy(),
                        x_ref.cpu().numpy())
    assert torch.equal(d_only, d)


@pytest.mark.gpu
def test_kernel_rejects_bad_input_on_card():
    dev = _cuda_or_skip()
    arrays, H, W = _cases()["cubes_64x64"]
    ta = [torch.from_numpy(a).to(dev) for a in arrays]
    with pytest.raises(ValueError, match="float32"):
        render_depth_xyz_cuda(ta[0].double(), *ta[1:], H, W)
    with pytest.raises(ValueError, match="faces"):
        render_depth_xyz_cuda(ta[0], ta[1].float(), *ta[2:], H, W)


@pytest.mark.gpu
@pytest.mark.parametrize("with_attrs", [True, False])
def test_pack_kernel_matches_torch_packing_on_card(with_attrs):
    dev = _cuda_or_skip()
    arrays = _adversarial_batch(_ADVERSARIAL, 5, 54, 72)
    verts, faces, R, t, K = (torch.from_numpy(a).to(dev) for a in arrays)
    R = torch.linalg.qr(torch.randn(len(R), 3, 3, generator=torch.Generator().manual_seed(0))
                        )[0].to(dev)                       # a rotation: R v + t rounds
    t = torch.tensor([0.01, -0.02, 0.3], device=dev).expand(len(R), 3).contiguous()
    for f in (faces, faces.long()):
        before = pack_faces_cuda.launches
        packed, boxes = pack_faces_cuda(verts, f, R, t, K, 54, 72, with_attrs=with_attrs)
        torch.cuda.synchronize()
        assert pack_faces_cuda.launches == before + 1
        fd = _pack_face_data(transform_verts(verts, R, t), verts, f, K, with_attrs)
        assert torch.equal(packed, face_major(fd))
        assert torch.equal(boxes, face_screen_boxes(fd, 54, 72))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W", [(64, 64), (54, 72)])
def test_kernel_matches_plain_on_adversarial_faces_on_card(H, W):
    dev = _cuda_or_skip()
    ta = [torch.from_numpy(a).to(dev) for a in _adversarial_batch(_ADVERSARIAL, 9, H, W)]
    d, x = render_depth_xyz_cuda(*ta, H, W)
    d_only, _ = render_depth_xyz_cuda(*ta, H, W, need_xyz=False)
    d_ref, x_ref = render_depth_xyz_batch(*ta, H, W)
    torch.cuda.synchronize()
    assert (d_ref > 0).any()
    assert torch.equal(d, d_ref) and torch.equal(x, x_ref) and torch.equal(d_only, d)
