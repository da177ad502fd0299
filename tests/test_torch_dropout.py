"""Port parity: DropBlock and drop_path in training, and the weight bridge
of ``loss.use_mtl``'s learned log-variances.

The JAX layers draw their masks from flax's "dropout" stream; the tests
record every ``jax.random.bernoulli`` result the JAX module draws (run op
by op) and feed the same masks, in the same order, to the port through
``models.layers.DropMasks``. Given the same masks:

  * ``DropBlock2D`` (block sizes 5 and 4: SAME padding is lopsided for an
    even block) equals the JAX layer at 1e-6, with the ramp's progress;
  * a ConvNeXt with drop_path_rate 0.6 equals the JAX backbone at the
    tolerance of ``tests/test_torch_convnext.py`` (1e-4 of the output's
    scale: five stages of convs summed in another order), and each block's
    drop_path is, at 1e-6, ``x + keep-mask * (block(x) - x) / keep`` of the
    same block in eval;
  * at rate 0, and in eval, both layers are the identity (bit for bit) and
    draw nothing.

The log-variances map both ways: ``state_dict_from_flax`` puts the JAX
package's ``log_var_*`` leaves into the port's GDRN strictly, and
``torch_parity_utils.flax_params_from_port`` brings them back unchanged.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from gdrnpp_bop2022_tpu.models.layers import DropBlock2D as JDropBlock
from gdrnpp_bop2022_torch.models.backbones.convnext import ConvNeXt
from gdrnpp_bop2022_torch.models.layers import DropBlock2D, DropMasks
from gdrnpp_bop2022_torch.utils.weights import _convnext, state_dict_from_flax
from torch_parity_utils import flax_params_from_port, jax_gdrn_params, port_gdrn, \
    random_like_tree, tiny_cfg


@contextlib.contextmanager
def recorded_bernoulli():
    """Every mask jax.random.bernoulli returns while the block runs."""
    got = []
    orig = jax.random.bernoulli

    def spy(key, p=0.5, shape=None):
        out = orig(key, p, shape)
        got.append(np.asarray(out))
        return out

    with mock.patch.object(jax.random, "bernoulli", spy):
        yield got


@pytest.mark.parametrize("block_size", [5, 4])
def test_dropblock_matches_jax_given_its_masks(block_size):
    x = np.random.RandomState(0).randn(3, 12, 10, 6).astype(np.float32)
    jm = JDropBlock(drop_prob=0.3, block_size=block_size)
    with recorded_bernoulli() as masks:
        want = np.asarray(jm.apply({}, jnp.asarray(x), deterministic=False, progress=0.7,
                                   rngs={"dropout": jax.random.PRNGKey(3)}))
    assert len(masks) == 1 and masks[0].shape == (3, 12, 10, 1) and masks[0].any()
    tm = DropBlock2D(drop_prob=0.3, block_size=block_size).train()
    given = [torch.from_numpy(masks[0]).permute(0, 3, 1, 2)]
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), DropMasks(given=given), progress=0.7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    assert not np.array_equal(want, x)


def test_dropblock_identity_at_rate_zero_and_in_eval():
    x = torch.randn(2, 4, 8, 8)
    empty = DropMasks(given=[])
    assert torch.equal(DropBlock2D(0.0).train()(x, empty), x)
    assert torch.equal(DropBlock2D(0.5).eval()(x, empty), x)
    with pytest.raises(ValueError, match="DropMasks"):
        DropBlock2D(0.5).train()(x)
    # the draws: seeds at gamma, from the generator on the activations' device
    g = torch.Generator().manual_seed(0)
    y = DropBlock2D(0.5, block_size=3).train()(torch.ones(64, 2, 9, 9), DropMasks(gen=g))
    assert 0.0 < float((y == 0).float().mean()) < 1.0


DEPTHS, DIMS = (1, 1, 2, 1), (16, 32, 32, 32)


def _convnext_pair(rate):
    jm = JConvNeXt(depths=DEPTHS, dims=DIMS, drop_path_rate=rate, dw_mode="conv",
                   dtype=jnp.float32)
    x = np.random.RandomState(1).randn(4, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    params = random_like_tree(shapes["params"], 2)
    tm = ConvNeXt(depths=DEPTHS, dims=DIMS, drop_path_rate=rate, dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in _convnext(params, DEPTHS).items()}, strict=True)
    return jm, params, tm, x


def test_drop_path_matches_jax_given_its_masks():
    jm, params, tm, x = _convnext_pair(0.6)
    with recorded_bernoulli() as masks:
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(7)}))
    # one (B, 1, 1, 1) mask per block but the first (rate 0 there)
    assert len(masks) == sum(DEPTHS) - 1 and all(m.shape == (4, 1, 1, 1) for m in masks)
    assert any(not m.all() for m in masks) and any(m.any() for m in masks)
    tm.train()
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
             DropMasks(given=[torch.from_numpy(m) for m in masks]))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    with torch.no_grad():
        tm.eval()
        plain = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (plain.permute(0, 2, 3, 1).numpy() - got).__abs__().max() > 1e-3


def test_drop_path_is_the_masked_branch_and_identity_at_rate_zero():
    _, _, tm, x = _convnext_pair(0.6)
    blk = tm.stages[2].blocks[1]
    keep = 1.0 - blk.drop_path
    h = torch.from_numpy(np.random.RandomState(4).randn(4, 32, 4, 4).astype(np.float32))
    h = h.contiguous(memory_format=torch.channels_last)
    mask = torch.tensor([True, False, True, False]).reshape(4, 1, 1, 1)
    with torch.no_grad():
        blk.eval()
        ref = blk(h)
        blk.train()
        got = blk(h, DropMasks(given=[mask]))
    want = h + mask.reshape(4, 1, 1, 1).float() * (ref - h) / keep
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # rate 0 (the first block) and eval draw nothing and change nothing
    first = tm.stages[0].blocks[0]
    assert first.drop_path == 0.0
    with torch.no_grad():
        first.train()
        a = first(torch.ones(1, 16, 4, 4), DropMasks(given=[]))
        first.eval()
        b = first(torch.ones(1, 16, 4, 4))
    assert torch.equal(a, b)


def test_log_vars_map_both_ways():
    cfg = tiny_cfg(**{"model.pose_net.loss.use_mtl": True})
    _, params = jax_gdrn_params(cfg, seed=4)
    names = sorted(k for k in params if k.startswith("log_var_"))
    assert len(names) == 21
    model = port_gdrn(cfg, params)                # strict: every leaf has a home
    for k in names:
        assert float(getattr(model, k)) == float(params[k])
    back = flax_params_from_port({k: v.detach().numpy() for k, v in model.state_dict().items()},
                                 cfg, params)
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_b) == len(flat_p)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path]), leaf), path
