"""Port parity: the rasterizer (kernel B2's plain version) against the JAX package.

The port's plain rasterizer is held against the XLA scan
``render_depth_xyz_batch`` and the Pallas kernel
``render_depth_xyz_pallas(interpret=True)`` on the fixtures of
tests/test_pallas_raster.py (cubes at 64x64, a ragged 54x72 image, the
depth-only mode), at that file's tolerances: identical silhouettes, depth
within 1e-5, xyz within 1e-4 where hit. ``_pack_face_data`` agrees with the
JAX one to fp32 rounding on the same camera-space vertices.

The CUDA kernel runs only on the card: the ``gpu`` tests at the end
compare it with the plain version there and skip on a machine without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops.pallas_raster import _pack_face_data as j_pack
from gdrnpp_bop2022_tpu.ops.pallas_raster import render_depth_xyz_pallas
from gdrnpp_bop2022_tpu.ops.rasterizer import render_depth_xyz_batch as j_render
from gdrnpp_bop2022_torch.ops.raster import _pack_face_data, render_depth_xyz_cuda
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
