"""Port parity: kernel B1's plain path against the Pallas kernel.

``layer_norm`` on a CPU tensor takes its plain version; it is checked
against ``layer_norm_pallas(..., interpret=True)`` on the cases of
tests/test_pallas_ln.py: fp32 at 2e-4 (the Pallas test's own bound), bf16
with a ragged row count at 0.05 (bf16 storage: one ulp at |y| < 4 is
<= 0.016, two roundings of the input and output stay inside 0.05).

The backward: the JAX package differentiates its jnp ``LayerNormFp32``
(the Pallas kernel has no VJP), so the port's plain backward (autograd
through ``layer_norm_ref``, which ``layer_norm`` runs on the CPU) is held to
``jax.grad`` through it in fp32 at 1e-5, on ragged row counts and
C = 96 / 100 / 128.

``_vector_path`` (which of the kernel's two paths a call takes) is
checked here; the CUDA kernels themselves run only on the card: the ``gpu``
tests at the end compare both paths of the forward and of the backward
with the plain versions there (C = 100 and an input offset by one element
take the scalar path) and skip on a machine without one. Backward
tolerances on the card: fp32 dx at 1e-5; bf16 dx within one bf16 ulp of the
plain dx + 1e-5; dweight / dbias at 1e-4 relative to the sum of the
absolute values of their terms (the kernel sums rows in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.ops.pallas_ln import layer_norm_pallas
from gdrnpp_bop2022_torch.ops import layer_norm as ln_mod
from gdrnpp_bop2022_torch.ops.layer_norm import (layer_norm, layer_norm_backward,
                                                 layer_norm_backward_ref, layer_norm_ref)
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
    # the forward and the backward entry points
    assert (cuda_build.CSRC / "layer_norm.cu").read_text().count(
        'extern "C"') == 2


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


@pytest.mark.parametrize("shape", [(5, 7, 96), (3, 11, 100), (2, 3, 5, 128)])
def test_plain_backward_matches_jax_grad(shape):
    # imported here: the card's machine has no flax, and collects this file
    from gdrnpp_bop2022_tpu.models.backbones.convnext import LayerNormFp32
    rs = np.random.RandomState(sum(shape))
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    C = shape[-1]
    w = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    mod = LayerNormFp32()

    def f(x_, w_, b_):
        y = mod.apply({"params": {"LayerNorm_0": {"scale": w_, "bias": b_}}}, x_)
        return jnp.sum(y * dy)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    layer_norm(xt, wt, bt).backward(torch.from_numpy(dy))     # the CPU path
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the wrapper's CPU path is the same plain backward
    dx, dw, db = layer_norm_backward(torch.from_numpy(dy), torch.from_numpy(x),
                                     torch.from_numpy(w), None, None)
    for got, ref in zip((dx, dw, db), (xt.grad, wt.grad, bt.grad)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert layer_norm_backward.launches == 0


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


def _bwd_case(dev, dtype, rows, C, offset=0):
    g = torch.Generator(device=dev).manual_seed(7 * rows + C + offset)
    buf = (torch.randn(rows * C + offset, device=dev, generator=g) * 2 + 0.5).to(dtype)
    dbuf = torch.randn(rows * C + offset, device=dev, generator=g).to(dtype)
    x, dy = buf[offset:].view(rows, C), dbuf[offset:].view(rows, C)
    w = 1 + 0.1 * torch.randn(C, device=dev, generator=g)
    b = 0.1 * torch.randn(C, device=dev, generator=g)
    return x, dy, w, b


def _check_bwd(x, dy, w, b):
    xr = x.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    br = b.detach().clone().requires_grad_(True)
    before = (layer_norm.launches, layer_norm_backward.launches,
              layer_norm_backward.reduce_launches)
    y = layer_norm(xr, wr, br)                  # gdrnpp::layer_norm with statistics
    y.backward(dy)
    torch.cuda.synchronize()
    assert (layer_norm.launches, layer_norm_backward.launches,
            layer_norm_backward.reduce_launches) == tuple(v + 1 for v in before)
    dx_ref, dw_ref, db_ref = layer_norm_backward_ref(dy, x, w)
    ref = dx_ref.float()
    err = (xr.grad.float() - ref).abs()
    if x.dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        _, e = torch.frexp(ref)
        assert (err <= torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5).all()
    xhat = (x.float() - x.float().mean(-1, keepdim=True)) * torch.rsqrt(
        x.float().var(-1, unbiased=False, keepdim=True) + 1e-6)
    for got, want, terms in ((wr.grad, dw_ref, (dy.float() * xhat).abs().sum(0)),
                             (br.grad, db_ref, dy.float().abs().sum(0))):
        assert ((got - want).abs() <= 1e-4 * terms + 1e-6).all()
    # the same bits again: no atomics, a fixed reduction order
    xr2 = x.detach().clone().requires_grad_(True)
    wr2 = w.detach().clone().requires_grad_(True)
    br2 = b.detach().clone().requires_grad_(True)
    layer_norm(xr2, wr2, br2).backward(dy)
    assert torch.equal(xr2.grad, xr.grad) and torch.equal(wr2.grad, wr.grad)
    assert torch.equal(br2.grad, br.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,C", [(48 * 4096, 128), (48 * 1024, 256), (48 * 256, 512),
                                    (48 * 64, 1024), (1001, 96), (37, 768)])
def test_backward_kernel_matches_plain_on_card(rows, C, dtype):
    dev = _cuda_or_skip()
    x, dy, w, b = _bwd_case(dev, dtype, rows, C)
    assert ln_mod._vector_path(x, dy, w, x)
    _check_bwd(x, dy, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,C,offset", [
    (torch.bfloat16, 1001, 100, 0), (torch.float32, 1001, 98, 0),
    (torch.bfloat16, 4096, 128, 1), (torch.float32, 4096, 128, 1),
    (torch.bfloat16, 37, 1024, 1), (torch.float32, 9, 2, 0)])
def test_backward_scalar_path_matches_plain_on_card(dtype, rows, C, offset):
    dev = _cuda_or_skip()
    x, dy, w, b = _bwd_case(dev, dtype, rows, C, offset)
    assert not ln_mod._vector_path(x, dy, w, x)
    _check_bwd(x, dy, w, b)
