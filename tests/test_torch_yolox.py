"""Port parity: the YOLOX detector (slice 4a) against the JAX package on the CPU.

The port's YOLOX holds the JAX package's params through
``utils/weights.py::yolox_state_dict_from_flax`` and gives the same raw
per-level outputs in fp32, within 1e-4 of each output's largest magnitude,
for GN and for BN with drawn running statistics, dense and depthwise. BN
runs at dep 0.33 / wid 0.125; GN at yolox_s's widths (dep 0.33 / wid 0.5):
at wid 0.125 most groups hold one channel of a 2x2 map, and the JAX model's
own fp32 rounding is amplified through ~60 such normalisations to 1e-4..2e-3
(each stage agrees to ~1e-6 given the same input:
``tests/test_torch_yolox_parts.py`` holds that). A reference-named state dict goes through the JAX package's
``convert_yolox_checkpoint`` (the released-weights route, with the Focus
permutation on it) to the same outputs. Decode and the NMS agree row for
row on identical raw outputs (``tests/test_torch_yolox_parts.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.yolox.yolox import YOLOX as JaxYOLOX
from gdrnpp_bop2022_tpu.utils.torch_port import convert_yolox_checkpoint
from gdrnpp_bop2022_torch.models.yolox.yolox import YOLOX
from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict, yolox_state_dict_from_flax
from torch_parity_utils import (jax_apply, jax_yolox, port_apply, port_yolox,
                                yolox_images)

NC = 3
OUT_TOL = 1e-4          # of each level's largest |output|


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_levels_close(want, got, tol=OUT_TOL):
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        assert a.shape == b.shape
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, err


@pytest.mark.parametrize("norm,depthwise,wid,size", [
    ("BN", False, 0.125, 64), ("BN", True, 0.125, 128),
    ("GN", False, 0.5, 64)])
def test_outputs_match_jax(norm, depthwise, wid, size):
    jm, params, stats = jax_yolox(norm, depthwise, wid, size)
    x = yolox_images(size)
    m = port_yolox(norm, depthwise, wid, yolox_state_dict_from_flax(params, stats))
    assert_levels_close(jax_apply(jm, params, stats, x), port_apply(m, x))


def test_released_weights_route():
    """A reference-named state dict (the port's, drawn from a seed) ->
    convert_yolox_checkpoint -> the JAX BN model gives the port's outputs;
    the bridge back gives the state dict bit for bit. Loading the stem
    without the Focus permutation moves the outputs far past the
    tolerance. (Dense, as the released yolox-x is; the bridge's depthwise
    names are held by test_outputs_match_jax.)"""
    m = YOLOX(NC, 0.33, 0.125, norm="BN", dtype=torch.float32).eval()
    sd = seeded_state_dict(m, 3)
    m.load_state_dict(sd, strict=True)
    variables = convert_yolox_checkpoint({k: v.numpy() for k, v in sd.items()},
                                         dep_mul=0.33)
    jm = JaxYOLOX(num_classes=NC, dep_mul=0.33, wid_mul=0.125, norm="BN", remat=False,
                  dtype=jnp.float32)
    x = yolox_images(64, seed=4)
    want = jax_apply(jm, variables["params"], variables["batch_stats"], x)
    got = port_apply(m, x)
    assert_levels_close(want, got)

    back = yolox_state_dict_from_flax(variables["params"], variables["batch_stats"])
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

    stem = "backbone.backbone.stem.conv.conv.weight"
    from gdrnpp_bop2022_torch.utils.channel_perm import focus_input_perm
    wrong = dict(sd)
    wrong[stem] = sd[stem][:, np.argsort(focus_input_perm(3))]     # JAX order, unpermuted
    m.load_state_dict(wrong, strict=True)
    bad = port_apply(m, x)
    assert max(np.abs(a - b).max() / np.abs(a).max() for a, b in zip(want, bad)) > 100 * OUT_TOL
