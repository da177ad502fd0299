"""Port parity: the ResNet, ResNeSt and CSPDarknet backbones of GDRN.

Each backbone at a 64^2 input, fp32, against the JAX module's features at
every stage index it has (ResNet and ResNeSt 0-3, CSPDarknet 1-3), with the
same numpy-drawn parameters bridged by ``utils/weights.py``. Tolerance 1e-4
of each feature's largest value: up to ~50 conv / GroupNorm layers in fp32
with sums in another order. Both packages pad as flax's "SAME" does; a
torch-style symmetric padding shifts every map by a pixel and fails here.
ResNeSt's stage-0 split attention is held to its degenerate GroupNorm (one
value a group: the output is the norm's bias; flax returns it exactly, torch's
GroupNorm, which folds the mean into a shift, up to 1.2e-4 of the bias's
largest here: rounding of x * rstd with rstd = 1 / sqrt(1e-5)). The 101-layer nets are held
only through the bridge (shapes from ``jax.eval_shape``, strict loading),
with no forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.models.backbones import resnest as j_resnest
from gdrnpp_bop2022_tpu.models.backbones import resnet as j_resnet
from gdrnpp_bop2022_tpu.models.gdrn import _CSPDarknetBackbone
from gdrnpp_bop2022_torch.models.backbones import resnest, resnet
from gdrnpp_bop2022_torch.models.gdrn import CSPDarknetBackbone, build_gdrn
from gdrnpp_bop2022_torch.utils.weights import _backbone, state_dict_from_flax
from torch_parity_utils import jax_gdrn_params, random_like_tree, tiny_cfg

ALL = (0, 1, 2, 3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(seed=0):
    return np.random.RandomState(seed).randn(2, 64, 64, 3).astype(np.float32)


def _jax_feats(jmod, x, seed):
    shapes = jax.eval_shape(lambda k: jmod.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    params = random_like_tree(shapes["params"], seed)
    feats = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    return params, [np.asarray(f) for f in feats]


def _port_feats(pmod, params, name, x):
    pmod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                          for k, v in _backbone(params, name).items()}, strict=True)
    with torch.no_grad():
        return [f.permute(0, 2, 3, 1).numpy()
                for f in pmod.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))]


def _close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"stage {i}")


@pytest.mark.parametrize("name", ["resnet34", "resnet50", "resnet18_8s"])
def test_resnet_matches_jax(name):
    x = _image(1)
    params, want = _jax_feats(getattr(j_resnet, name)(out_indices=ALL, dtype=jnp.float32), x, 2)
    got = _port_feats(getattr(resnet, name)(out_indices=ALL, dtype=torch.float32), params,
                      name, x)
    _close(got, want)
    # strides 4, 8, 16, 32; the dilated net stays at 8 from stage 1 on
    sides = (16, 8, 8, 8) if name.endswith("_8s") else (16, 8, 4, 2)
    assert tuple(f.shape[1] for f in got) == sides


def test_resnest50_matches_jax_and_stage0_attention_is_its_bias():
    x = _image(3)
    params, want = _jax_feats(j_resnest.resnest50(out_indices=ALL, dtype=jnp.float32), x, 4)
    port = resnest.resnest50(out_indices=ALL, dtype=torch.float32)
    seen = {}
    for stage in (1, 2):
        norm = getattr(port, f"layer{stage}")[0].conv2.bn1
        norm.register_forward_hook(lambda m, i, o, s=stage: seen.__setitem__(s, (o, m.bias)))
    _close(_port_feats(port, params, "resnest50", x), want)
    with torch.no_grad():
        out0, bias0 = seen[1]        # inter = 32 channels in 32 groups: one value each
        assert float((out0 - bias0).abs().max()) <= 1e-3 * float(bias0.abs().max())
        out1, bias1 = seen[2]        # inter = 64: two values a group
        assert float((out1 - bias1).abs().max()) >= 0.1 * float(bias1.abs().max())


def test_cspdarknet_backbone_matches_jax():
    x = _image(5)
    jm = _CSPDarknetBackbone(out_indices=(1, 2, 3), dtype=jnp.float32)    # width, depth 1
    params, want = _jax_feats(jm, x, 6)
    port = CSPDarknetBackbone(out_indices=(1, 2, 3), dtype=torch.float32)
    _close(_port_feats(port, params, "cspdarknet", x), want)
    with pytest.raises(ValueError, match="1-3"):
        CSPDarknetBackbone(out_indices=(0, 1, 2, 3))


@pytest.mark.parametrize("name", ["resnet101", "resnest101"])
def test_bridge_loads_101_layer_gdrn_strict(name):
    cfg = tiny_cfg(**{"model.pose_net.backbone.name": name})
    _, params = jax_gdrn_params(cfg, seed=7)
    sd = state_dict_from_flax(params, cfg)
    with torch.device("meta"):
        model = build_gdrn(cfg, device="meta")
    missing, unexpected = model.load_state_dict(sd, strict=True, assign=True)
    assert not missing and not unexpected
    assert len(getattr(model.backbone, "layer3")) == 23
