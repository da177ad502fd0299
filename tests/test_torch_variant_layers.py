"""Port parity: the layers of the GDRN variants against the JAX package.

AconC, soft_argmax, CoordAtt (with a bottleneck width that 8 does not
divide), the weight-standardised and weight-centred convs and transposed
convs, and flax's "SAME" padding (``same_pads``, ``Conv2dSame``,
``MaxPoolSame``, ``AvgPoolSame``) against ``lax.padtype_to_pads`` and flax's
conv and pools at strides 1 and 2 on even and odd sizes. fp32 on the CPU,
parameters from a numpy seed; single layers are held at 1e-5 of each
output's largest value (pools and padding exactly).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models import layers as jl
from gdrnpp_bop2022_torch.models import layers as tl
from gdrnpp_bop2022_torch.utils.weights import _conv, _conv_transpose
from torch_parity_utils import random_like_tree

RS = np.random.RandomState


def _init(mod, *xs, seed=0):
    shapes = jax.eval_shape(lambda k: mod.init(k, *[jnp.asarray(x) for x in xs]),
                            jax.random.PRNGKey(0))["params"]
    return random_like_tree(shapes, seed)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-6))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_acon_c_matches_jax():
    x = RS(0).randn(2, 5, 6, 16).astype(np.float32)
    params = _init(jl.AconC(), x, seed=1)
    port = tl.AconC(16)
    port.load_state_dict({k: _t(params[k]) for k in ("p1", "p2", "beta")})
    _close(port(_nchw(x)), jl.AconC().apply({"params": params}, jnp.asarray(x)))


def test_conv_module_with_acon_names_its_activation():
    m = tl.ConvModule(4, 8, act="acon")
    assert {k for k in m.state_dict() if "acon" in k} == {"acon.p1", "acon.p2", "acon.beta"}


def test_soft_argmax_matches_jax():
    rs = RS(2)
    x = (rs.randn(2, 6, 7, 9) * 0.01).astype(np.float32)   # near ties: beta = 1000 matters
    x[0, 0, 0, 3] += 0.05
    want = jl.soft_argmax(jnp.asarray(x))
    got = tl.soft_argmax(_nchw(x))
    assert got.shape == (2, 1, 6, 7)
    _close(got, want)
    assert abs(float(got[0, 0, 0, 0]) - 3.0) < 1e-6          # a clear winner is its index


@pytest.mark.parametrize("C", [64, 384])      # mip 8 (GN 8 groups), 12 (gcd(8, 12) = 4)
def test_coord_att_matches_jax(C):
    x = RS(3).randn(2, 5, 7, C).astype(np.float32)
    jm = jl.CoordAtt(features=C, reduction=32, dtype=jnp.float32)
    params = _init(jm, x, seed=4)
    port = tl.CoordAtt(C, dtype=torch.float32)
    sd = {"bn1.weight": _t(params["norm1"]["GroupNorm_0"]["scale"]),
          "bn1.bias": _t(params["norm1"]["GroupNorm_0"]["bias"])}
    for name in ("conv1", "conv_h", "conv_w"):
        sd[f"{name}.weight"] = _t(_conv(params[name]["kernel"]))
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    port.load_state_dict(sd, strict=True)
    mip = max(8, C // 32)
    assert port.bn1.num_groups == np.gcd(8, mip)
    _close(port(_nchw(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["StdConv", "StdConvTranspose", "MeanConv",
                                  "MeanConvTranspose"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (4, 2)])
def test_mapped_convs_match_jax(kind, k, s):
    x = RS(5).randn(2, 7, 8, 6).astype(np.float32)
    jm = getattr(jl, kind)(5, (k, k), strides=(s, s), dtype=jnp.float32)
    params = _init(jm, x, seed=6)
    port = getattr(tl, kind)(6, 5, k, stride=s, dtype=torch.float32)
    kern = params["conv"]["kernel"]
    port.load_state_dict({"weight": _t((_conv_transpose if "Transpose" in kind else _conv)(kern)),
                          "bias": _t(params["conv"]["bias"])}, strict=True)
    _close(port(_nchw(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_same_pads_match_lax():
    for n in range(1, 12):
        for k in (1, 2, 3, 4, 7):
            for s in (1, 2, 3):
                for d in (1, 2):
                    want = jax.lax.padtype_to_pads((n,), ((k - 1) * d + 1,), (s,), "SAME")[0]
                    assert tuple(tl.same_pads(n, k, s, d)) == tuple(want), (n, k, s, d)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("s", [1, 2])
def test_same_conv_and_pools_match_flax(size, s):
    x = RS(7).randn(2, size, size, 4).astype(np.float32)
    for k in (2, 3):
        want = fnn.max_pool(jnp.asarray(x), (k, k), strides=(s, s), padding="SAME")
        np.testing.assert_array_equal(tl.MaxPoolSame(k, s)(_nchw(x)).permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))
        want = fnn.avg_pool(jnp.asarray(x), (k, k), strides=(s, s), padding="SAME")
        _close(tl.AvgPoolSame(k, s)(_nchw(x)), want, 1e-6)
    for k, d in ((3, 1), (7, 1), (3, 2), (1, 1)):
        jm = fnn.Conv(5, (k, k), strides=(s, s), kernel_dilation=(d, d), padding="SAME",
                      use_bias=False)
        params = _init(jm, x, seed=8)
        port = tl.Conv2dSame(4, 5, k, s, d, dtype=torch.float32)
        port.load_state_dict({"weight": _t(_conv(params["kernel"]))}, strict=True)
        _close(port(_nchw(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_avg_pool_divides_by_the_whole_window():
    """flax's SAME average pool counts the zero padding: on a 4x4 ramp the
    stride-1 window at (1, 3) overhangs the right edge and gives 39 / 9, the
    stride-2 one at (1, 1) the bottom-right corner's 50 / 9."""
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    assert abs(float(tl.AvgPoolSame(3, 1)(x)[0, 0, 1, 3]) - 39.0 / 9.0) < 1e-6
    assert abs(float(tl.AvgPoolSame(3, 2)(x)[0, 0, 1, 1]) - 50.0 / 9.0) < 1e-6
