"""Port parity: kernel B1's plain path against the Pallas kernel.

``layer_norm`` on a CPU tensor takes its plain version; it is checked
against ``layer_norm_pallas(..., interpret=True)`` on the cases of
tests/test_pallas_ln.py: fp32 at 2e-4 (the Pallas test's own bound), bf16
with a ragged row count at 0.05 (bf16 storage: one ulp at |y| < 4 is
<= 0.016, two roundings of the input and output stay inside 0.05).

``_vector_path`` (which of the kernel's two paths a call takes) is
checked here; the CUDA kernel itself runs only on the card: the ``gpu``
tests at the end compare both paths with the plain version there (C = 100
and an input offset by one element take the scalar path) and skip on a
machine without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops.pallas_ln import layer_norm_pallas
from gdrnpp_bop2022_torch.ops import layer_norm as ln_mod
from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_ref
from gdrnpp_bop2022_torch.utils import cuda_build


def _pallas(x, scale, bias, dtype, tile=256):
    return np.asarray(layer_norm_pallas(jnp.asarray(x, dtype), jnp.asarray(scale),
                                        jnp.asarray(bias), tile=tile,
                                        interpret=True).astype(jnp.float32))


def test_plain_matches_pallas_fp32():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8, 8, 128).astype(np.float32)
    scale = rs.randn(128).astype(np.float32)
    bias = rs.randn(128).astype(np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(x, scale, bias, jnp.float32),
                               atol=2e-4)


def test_plain_matches_pallas_bf16_ragged_rows():
    rs = np.random.RandomState(1)
    x = rs.randn(5, 3, 3, 256).astype(np.float32)          # 45 rows, tile 16
    scale = np.ones(256, np.float32)
    bias = np.zeros(256, np.float32)
    got = layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                     torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               _pallas(x, scale, bias, jnp.bfloat16, tile=16),
                               atol=0.05)


def test_cpu_path_is_plain_and_counts_no_launch():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(7, 96).astype(np.float32))
    w, b = torch.ones(96), torch.zeros(96)
    before = layer_norm.launches
    torch.testing.assert_close(layer_norm(x, w, b), layer_norm_ref(x, w, b),
                               rtol=0, atol=0)
    assert layer_norm.launches == before


def test_rejects_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        layer_norm(x, torch.ones(8), torch.zeros(8))


def test_nvcc_command_targets_hopper(tmp_path):
    cmd = cuda_build.nvcc_command("nvcc", cuda_build.CSRC / "layer_norm.cu",
                                  tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cuda_build.library_path("layer_norm").parent == cuda_build.BUILD_DIR
    assert (cuda_build.CSRC / "layer_norm.cu").read_text().count(
        'extern "C"') == 1


@pytest.mark.parametrize("dtype,C,offset,vector", [
    (torch.bfloat16, 128, 0, True), (torch.bfloat16, 1024, 0, True),
    (torch.bfloat16, 100, 0, False), (torch.bfloat16, 128, 1, False),
    (torch.float32, 100, 0, True), (torch.float32, 98, 0, False),
    (torch.float32, 128, 1, False), (torch.float32, 128, 4, True)])
def test_vector_path_needs_whole_vectors_and_alignment(dtype, C, offset, vector):
    buf = torch.zeros(4 * C + offset, dtype=dtype)
    x = buf[offset:].view(4, C)
    w, b = torch.ones(C), torch.zeros(C)
    assert ln_mod._vector_path(x, torch.empty_like(x), w, b) == vector
    assert not ln_mod._vector_path(x, torch.empty_like(x), torch.ones(C + 1)[1:], b)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the B1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,C", [(4096, 128), (1024, 256), (256, 512),
                                    (64, 1024), (1001, 96), (37, 768)])
def test_kernel_matches_plain_on_card(rows, C, dtype):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(rows + C)
    x = (torch.randn(rows, C, device=dev, generator=g) * 3 + 1).to(dtype)
    w = torch.randn(C, device=dev, generator=g)
    b = torch.randn(C, device=dev, generator=g)
    before = layer_norm.launches
    y = layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    ref = layer_norm_ref(x, w, b).float()
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    else:  # within one bf16 ulp of the output, plus fp32 slack near zero
        _, e = torch.frexp(ref)
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)
        assert ((y.float() - ref).abs() <= ulp + 1e-5).all()


@pytest.mark.gpu
def test_kernel_rejects_bad_input_on_card():
    dev = _cuda_or_skip()
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(TypeError):
        layer_norm(torch.zeros(4, 64, device=dev, dtype=torch.float16), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(torch.zeros(64, 4, device=dev).t(), w, b)
    with pytest.raises(ValueError, match="C <= 1024"):
        big = torch.ones(2048, device=dev)
        layer_norm(torch.zeros(2, 2048, device=dev), big, big)
    assert ln_mod.MAX_CHANNELS == 1024


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,C,offset", [
    (torch.bfloat16, 1001, 100, 0), (torch.float32, 1001, 98, 0),
    (torch.bfloat16, 4096, 128, 1), (torch.float32, 4096, 128, 1),
    (torch.bfloat16, 37, 1024, 1), (torch.float32, 37, 1024, 1),
    (torch.bfloat16, 9, 36, 0), (torch.float32, 9, 2, 0)])
def test_scalar_path_matches_plain_on_card(dtype, rows, C, offset):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(rows + C + offset)
    buf = (torch.randn(rows * C + offset, device=dev, generator=g) * 3 + 1).to(dtype)
    x = buf[offset:].view(rows, C)
    w = torch.randn(C, device=dev, generator=g)
    b = torch.randn(C, device=dev, generator=g)
    y = layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert not ln_mod._vector_path(x, y, w, b)
    ref = layer_norm_ref(x, w, b).float()
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    else:
        _, e = torch.frexp(ref)
        assert ((y.float() - ref).abs() <= torch.ldexp(torch.ones_like(ref), e - 8)
                + 1e-5).all()
