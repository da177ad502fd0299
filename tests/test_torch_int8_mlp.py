"""Port parity: int8 MLP serving (``backbone.int8_mlp``) against JAX.

* ``dense_int8`` against the JAX ``_dense_int8`` on seeded inputs, bf16 and
  fp32 activations: the int8 codes of the weights and of the activations
  and the int32 accumulators are equal (exactly), the output within one
  bf16 ulp of the JAX output (one fp32 ulp for fp32). The JAX side's codes
  come from the same expressions run op by op, whose output is held
  bit-equal to ``_dense_int8``'s own.
* A tiny ConvNeXt GDRN (convnext_tiny, fp32) with ``int8_mlp=True`` in eval
  mode against the JAX one. Block by block, each of the 18 port blocks
  given the JAX block's own input (flax's captured intermediates): the
  median element equal within 1e-6 of the output's largest, every element
  within 5e-3 (measured 2.6e-3). Both sides quantize the same function, but
  their fp32 LayerNorm outputs differ by ~1e-7, so the odd activation sits
  on the other side of a rounding boundary and moves by one code (1/127 of
  the tensor's largest). Chained through the whole model those flips
  cascade (a moved activation moves the next layer's inputs by far more
  than 1e-7, and the per-tensor scale spreads them), so the whole model's
  outputs are held at 0.1 of each output's largest (measured 1.4-5.6e-2,
  the size of int8's own difference from fp32), bit-equal from run to run
  and different from the fp32 model's.
* The training path with ``int8_mlp=True`` is the fp32 MLP path on the same
  parameters (bit-equal outputs) and gives non-zero MLP gradients; the
  state dict is the same as without the flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.backbones.convnext import _dense_int8
from gdrnpp_bop2022_torch.models.backbones.convnext import (dense_int8, int8_codes,
                                                            int8_matmul)
from torch_parity_utils import jax_gdrn_params, port_gdrn, roi_batch, tiny_cfg, to_torch


def _jax_steps(x, w, b):
    """``_dense_int8``'s lines op by op, as it runs called eagerly,
    returning its intermediates too."""
    w_s = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8) / 127.0
    wq = jnp.round(w / w_s).astype(jnp.int8)
    x32 = x.astype(jnp.float32)
    x_s = jnp.maximum(jnp.max(jnp.abs(x32)), 1e-8) / 127.0
    xq = jnp.round(x32 / x_s).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    out = (acc.astype(jnp.float32) * (x_s * w_s) + b.astype(jnp.float32)).astype(x.dtype)
    return wq, xq, acc, out


def _ulp(v: np.ndarray, mant_bits: int) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - mant_bits)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_int8_matches_jax(dtype):
    rs = np.random.RandomState(0)
    B, H, W, cin, cout = 2, 4, 6, 32, 128
    x = rs.randn(B, H, W, cin).astype(np.float32) * 2.0
    w = (rs.randn(cin, cout) / np.sqrt(cin)).astype(np.float32)   # flax (Cin, Cout)
    b = (0.1 * rs.randn(cout)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x).astype(jdt)
    wq_j, xq_j, acc_j, out_j = jax.device_get(_jax_steps(xj, jnp.asarray(w), jnp.asarray(b)))
    real = np.asarray(_dense_int8(xj, jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(out_j.astype(np.float32)), real)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wt = torch.from_numpy(np.ascontiguousarray(w.T))               # torch (Cout, Cin)
    xq, x_s, wq, w_s = int8_codes(xt.reshape(-1, cin), wt)
    np.testing.assert_array_equal(wq.numpy().T, wq_j)
    np.testing.assert_array_equal(xq.numpy(), xq_j.reshape(-1, cin))
    acc = int8_matmul(xq, wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j.reshape(-1, cout))
    np.testing.assert_array_equal(acc.numpy(), xq.int().numpy() @ wq.int().numpy().T)

    got = dense_int8(xt, wt, torch.from_numpy(b))
    assert got.dtype == xt.dtype and got.shape == (B, H, W, cout)
    got = got.float().numpy()
    want = real
    mant = 7 if dtype == "bfloat16" else 23
    assert np.all(np.abs(got - want) <= _ulp(want, mant)), np.abs(got - want).max()


@pytest.fixture(scope="module")
def tiny_int8():
    cfg = tiny_cfg(**{"model.pose_net.backbone.int8_mlp": True})
    jm, params = jax_gdrn_params(cfg, seed=0)
    b = roi_batch(cfg, B=3, seed=1)
    want, inter = jax.device_get(jax.jit(lambda p, bb: jm.apply(
        {"params": p}, **bb, capture_intermediates=True))(
            params, {k: jnp.asarray(v) for k, v in b.items()}))
    return cfg, params, b, want, inter["intermediates"]["backbone"]


_KEYS = ("rot", "trans", "vis_mask", "full_mask", "coor_x", "region")


def test_int8_blocks_match_jax(tiny_int8):
    """Each int8 block of the port, given the JAX block's own input, against
    the JAX block's output."""
    cfg, params, _, _, inter = tiny_int8
    port = port_gdrn(cfg, params).eval()
    out = lambda name: np.asarray(inter[name]["__call__"][0])    # noqa: E731
    worst = 0.0
    for s, stage in enumerate(port.backbone.stages):
        x = out("stem_norm" if s == 0 else f"downsample_conv{s}")
        for i, blk in enumerate(stage.blocks):
            assert blk.int8_mlp
            want = out(f"stage{s}_block{i}")
            with torch.no_grad():
                got = blk(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
            got = got.permute(0, 2, 3, 1).numpy()
            scale = np.abs(want).max()
            worst = max(worst, float(np.abs(got - want).max() / scale))
            assert np.median(np.abs(got - want)) <= 1e-6 * scale, (s, i)
            x = want
    assert worst <= 5e-3, worst


def test_int8_gdrn_matches_jax(tiny_int8):
    cfg, params, b, want, _ = tiny_int8
    port = port_gdrn(cfg, params).eval()
    with torch.no_grad():
        got = port(**to_torch(b))
        again = port(**to_torch(b))
    fp32 = port_gdrn(tiny_cfg(), params).eval()
    with torch.no_grad():
        plain = fp32(**to_torch(b))
    for k in _KEYS:
        w, g = np.asarray(want[k]), got[k].numpy()
        scale = np.abs(w).max()
        assert np.isfinite(g).all() and np.abs(g - w).max() <= 0.1 * scale, k
        assert torch.equal(got[k], again[k]), k
        assert not np.array_equal(g, plain[k].numpy()), k


def test_int8_training_path_is_fp32_mlp(tiny_int8):
    cfg, params, b, _, _ = tiny_int8
    port = port_gdrn(cfg, params).train()
    ref = port_gdrn(tiny_cfg(), params).train()
    assert port.state_dict().keys() == ref.state_dict().keys()
    out = port(**to_torch(b))
    out_ref = ref(**to_torch(b))
    for k in _KEYS:
        assert torch.equal(out[k], out_ref[k]), k
    sum(out[k].float().square().mean() for k in _KEYS).backward()
    for name, p in port.backbone.named_parameters():
        if ".mlp." in name:
            assert p.grad is not None and p.grad.abs().max() > 0, name
