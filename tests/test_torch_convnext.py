"""Port parity: ConvNeXt (the module that holds kernel B1) against JAX.

A small ConvNeXt(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256)) at 64x64,
fp32 on the CPU, parameters from a numpy seed. On the CPU every LayerNorm
takes B1's plain path. With dw_mode="auto" the JAX side lowers the
depthwise 7x7 to its MXU scatter-matmul (every stage is <= 16x16), so the
port's grouped conv is also checked against that lowering; "conv" checks
it against XLA's grouped conv.

Tolerance 1e-4 relative to the output's scale: five stages of convs,
GELUs and renormalisation in fp32, with sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from gdrnpp_bop2022_torch.models.backbones.convnext import ConvNeXt, convnext_base
from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
from gdrnpp_bop2022_torch.utils.weights import _convnext
from torch_parity_utils import random_like_tree

DEPTHS, DIMS = (1, 1, 2, 1), (32, 64, 128, 256)


def _pair(gelu_exact, dw_mode, seed=0):
    jm = JConvNeXt(depths=DEPTHS, dims=DIMS, gelu_exact=gelu_exact,
                   dw_mode=dw_mode, dtype=jnp.float32)
    x = np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))["params"]
    params = random_like_tree(shapes, seed)
    tm = ConvNeXt(depths=DEPTHS, dims=DIMS, gelu_exact=gelu_exact,
                  dtype=torch.float32).eval()
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in _convnext(params, DEPTHS).items()}, strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("gelu_exact,dw_mode", [(False, "auto"), (True, "auto"),
                                                (False, "conv")])
def test_convnext_matches_jax(gelu_exact, dw_mode):
    jm, params, tm, x = _pair(gelu_exact, dw_mode)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 256, 2, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_tanh_and_exact_gelu_differ():
    """The default is the tanh GELU (as in the JAX package); the exact one
    must be a different function, or the parity above proves nothing."""
    _, _, tm_tanh, x = _pair(False, "auto")
    tm_exact = ConvNeXt(depths=DEPTHS, dims=DIMS, gelu_exact=True,
                        dtype=torch.float32).eval()
    tm_exact.load_state_dict(tm_tanh.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert (tm_tanh(xt) - tm_exact(xt)).abs().max() > 1e-4


def test_convnext_base_names_and_layer_norm_count():
    """timm names, and the 40 LayerNorms of convnext_base (stem, 3
    downsamples, 36 blocks) that B1 serves on the card."""
    m = convnext_base(dtype=torch.float32)
    names = set(m.state_dict())
    for k in ("stem.0.weight", "stem.1.bias", "stages.1.downsample.0.weight",
              "stages.1.downsample.1.weight", "stages.2.blocks.26.conv_dw.weight",
              "stages.2.blocks.26.norm.weight", "stages.3.blocks.2.mlp.fc1.weight",
              "stages.3.blocks.2.mlp.fc2.bias", "stages.0.blocks.0.gamma"):
        assert k in names, k
    norms = [k for k in names if k.endswith(".weight") and m.state_dict()[k].ndim == 1]
    assert len(norms) == 40


def test_forward_calls_layer_norm_40_times(monkeypatch):
    """Every LayerNorm of the backbone goes through ops.layer_norm."""
    import gdrnpp_bop2022_torch.models.backbones.convnext as cx
    calls = []

    def spy(x, w, b, eps=1e-6):
        calls.append(tuple(x.shape))
        return layer_norm(x, w, b, eps)

    monkeypatch.setattr(cx, "layer_norm", spy)
    m = ConvNeXt(depths=(3, 3, 27, 3), dims=(8, 8, 8, 8), dtype=torch.float32).eval()
    with torch.no_grad():
        m(torch.zeros(1, 3, 32, 32))
    assert len(calls) == 40
    assert all(s[-1] == 8 for s in calls)
