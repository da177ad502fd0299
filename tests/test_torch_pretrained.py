"""Port parity: the pretrained-backbone loader (``backbone.pretrained``)
against the JAX ``utils/torch_port.py::load_pretrained_backbone``.

A synthetic timm-named ConvNeXt state dict (convnext_tiny's depths at narrow
widths, so the files stay small: both loaders take the depths from the name
and the widths from the checkpoint) is saved with each wrapper (none,
{"model": ...}, {"state_dict": ...}) and each prefix (none, 'module.',
'_module.', 'backbone.'), and loaded at in_channels 1, 3 and 6: the port's
state dict equals, bit for bit, the JAX loader's flax tree mapped to torch
names (``utils/weights.py::_backbone``, the backbone part of
``state_dict_from_flax``). An ``.npz`` of flat flax paths loads likewise;
one missing or foreign path raises. A torch checkpoint of a non-ConvNeXt
backbone raises NotImplementedError in both loaders; a missing parameter
raises KeyError, a wrong shape ValueError. The trainer's loader adapts an
RGB checkpoint to a 6-channel stem. No tolerance: every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.utils import torch_port as jtp
from gdrnpp_bop2022_torch.models.backbones.convnext import ConvNeXt
from gdrnpp_bop2022_torch.utils.weights import (_backbone, adapt_input_conv,
                                                load_pretrained_backbone, seeded_state_dict)

DEPTHS, DIMS = (3, 3, 9, 3), (8, 16, 24, 32)


def _timm_sd(seed=0):
    return seeded_state_dict(ConvNeXt(DEPTHS, DIMS, in_chans=3), seed)


def _save(path, sd, prefix, wrapper):
    sd = {prefix + k: v for k, v in sd.items()}
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)


def _from_flax(tree) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in _backbone(tree, "convnext_tiny").items()}


def _assert_sd_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("wrapper", [None, "model", "state_dict"])
@pytest.mark.parametrize("prefix", ["", "module.", "_module.", "backbone."])
@pytest.mark.parametrize("in_ch", [1, 3, 6])
def test_torch_checkpoint_matches_jax_loader(tmp_path, in_ch, prefix, wrapper):
    path = str(tmp_path / "convnext.pth")
    _save(path, _timm_sd(), prefix, wrapper)
    tree = jtp.load_pretrained_backbone(path, None, "convnext_tiny", in_channels=in_ch)
    target = ConvNeXt(DEPTHS, DIMS, in_chans=in_ch)
    got = load_pretrained_backbone(path, target, "convnext_tiny", in_channels=in_ch)
    _assert_sd_equal(got, _from_flax(tree))
    assert got["stem.0.weight"].shape[1] == in_ch
    target.load_state_dict(got, strict=True)


def test_adapt_input_conv_matches_jax():
    w = torch.from_numpy(np.random.RandomState(1).randn(8, 3, 4, 4).astype(np.float32))
    for c in (1, 2, 3, 4, 6, 7):
        want = jtp.adapt_input_conv(np.transpose(w.numpy(), (2, 3, 1, 0)), c)
        got = adapt_input_conv(w, c)
        np.testing.assert_array_equal(got.numpy(), np.transpose(want, (3, 2, 0, 1)))


def _flat_flax(sd) -> dict:
    """The flax backbone tree of a timm state dict, as flat '/' paths."""
    tree = jtp.convert_convnext_timm({k: v.numpy() for k, v in sd.items()}, depths=DEPTHS)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return tree, {"/".join(str(p.key) for p in path): np.asarray(v) for path, v in flat}


def test_npz_matches_jax_loader(tmp_path):
    tree, flat = _flat_flax(_timm_sd(seed=2))
    path = str(tmp_path / "bb.npz")
    np.savez(path, **flat)
    want = jtp.load_pretrained_backbone(path, tree, "convnext_tiny")
    got = load_pretrained_backbone(path, ConvNeXt(DEPTHS, DIMS), "convnext_tiny")
    _assert_sd_equal(got, _from_flax(want))


def test_npz_missing_or_foreign_path_raises(tmp_path):
    _, flat = _flat_flax(_timm_sd())
    missing = dict(flat)
    missing.pop("stage2_block4/pwconv1/kernel")
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(KeyError, match="lacks"):
        load_pretrained_backbone(str(tmp_path / "missing.npz"), ConvNeXt(DEPTHS, DIMS),
                                 "convnext_tiny")
    np.savez(tmp_path / "foreign.npz", **flat, **{"head/fc/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="not paths"):
        load_pretrained_backbone(str(tmp_path / "foreign.npz"), ConvNeXt(DEPTHS, DIMS),
                                 "convnext_tiny")
    with pytest.raises(KeyError):
        jtp.load_pretrained_backbone(str(tmp_path / "foreign.npz"),
                                     _flat_flax(_timm_sd())[0], "convnext_tiny")


def test_non_convnext_torch_checkpoint_raises(tmp_path):
    from gdrnpp_bop2022_torch.models.backbones.resnet import resnet34
    path = str(tmp_path / "r34.pth")
    torch.save(resnet34().state_dict(), path)
    with pytest.raises(NotImplementedError):
        jtp.load_pretrained_backbone(path, None, "resnet34")
    with pytest.raises(NotImplementedError, match="convnext"):
        load_pretrained_backbone(path, resnet34(), "resnet34")


def test_missing_and_misshapen_parameters_raise(tmp_path):
    sd = _timm_sd()
    sd.pop("stages.2.blocks.8.gamma")
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="lacks"):
        load_pretrained_backbone(str(tmp_path / "short.pth"), ConvNeXt(DEPTHS, DIMS),
                                 "convnext_tiny")
    torch.save(_timm_sd(), tmp_path / "full.pth")
    with pytest.raises(ValueError, match="shape"):
        load_pretrained_backbone(str(tmp_path / "full.pth"),
                                 ConvNeXt(DEPTHS, (8, 16, 24, 40)), "convnext_tiny")


def test_trainer_loader_adapts_the_stem(tmp_path):
    """``engine.trainer._load_pretrained_backbone`` reads the name and
    in_channels from the model's config (a 6-channel early-fusion stem)."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.engine.trainer import _load_pretrained_backbone
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    cfg = replace_cfg(Config(), {
        "model.pose_net.num_classes": 2, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.backbone.in_channels": 6, "model.pose_net.geo_head.feat_dim": 32,
        "model.pose_net.geo_head.num_gn_groups": 8, "model.pose_net.geo_head.num_regions": 8,
        "model.pose_net.pnp_net.featdim": 32, "model.pose_net.pnp_net.num_gn_groups": 8,
        "model.compute_dtype": "float32"})
    model = build_gdrn(cfg, device="cpu")
    src = seeded_state_dict(ConvNeXt((3, 3, 9, 3), (96, 192, 384, 768)), 3)
    _save(str(tmp_path / "tiny.pth"), src, "module.", "state_dict")
    _load_pretrained_backbone(model, str(tmp_path / "tiny.pth"))
    got = model.backbone.state_dict()
    assert torch.equal(got["stem.0.weight"], adapt_input_conv(src["stem.0.weight"], 6))
    assert torch.equal(got["stem.0.weight"][:, 3:], got["stem.0.weight"][:, :3])
    assert torch.equal(got["stages.3.blocks.2.mlp.fc2.weight"],
                       src["stages.3.blocks.2.mlp.fc2.weight"])
