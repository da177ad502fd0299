"""``backbone.remat``: each ConvNeXt block recomputed in the backward pass
(``torch.utils.checkpoint``, as the JAX package's ``nn.remat(ConvNeXtBlock)``).

* A tiny ConvNeXt GDRN (convnext_tiny, fp32, CPU) in training mode, with
  and without remat: the outputs and every parameter's gradient are
  bit-equal (the recompute runs the same operations on the same inputs).
* A ConvNeXt with drop_path 0.3 and its masks drawn from a generator: the
  gradients are bit-equal with and without remat, and the generator ends in
  the same state (each mask is drawn once, before its block, not again in
  the recompute); with masks given as a list, every mask is taken once.
* remat is a training-only switch: in eval mode the forward is the same
  function, and without gradients no checkpoint is taken.
"""

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.models.backbones.convnext import ConvNeXt
from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
from gdrnpp_bop2022_torch.models.layers import DropMasks
from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

TINY = {"model.pose_net.num_classes": 2, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32"}
KEYS = ("rot", "trans", "vis_mask", "full_mask", "coor_x", "coor_y", "coor_z", "region")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B=2, seed=1):
    rs = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))     # noqa: E731
    return {"roi_img": t(rs.randn(B, 64, 64, 3)),
            "roi_labels": torch.from_numpy(rs.randint(0, 2, B)),
            "roi_coord_2d": t(rs.rand(B, 16, 16, 2)),
            "roi_cams": t(np.tile([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], (B, 1, 1))),
            "roi_centers": t(rs.uniform(100, 400, (B, 2))),
            "roi_whs": t(rs.uniform(40, 120, (B, 2))),
            "roi_extents": t(rs.uniform(0.05, 0.2, (B, 3))),
            "resize_ratios": t(rs.uniform(0.3, 1.0, B))}


def _gdrn_grads(remat: bool):
    cfg = replace_cfg(Config(), {**TINY, "model.pose_net.backbone.remat": remat})
    model = build_gdrn(cfg, device="cpu", train=True)
    model.load_state_dict(seeded_state_dict(model, 0))
    assert all(st.remat == remat for st in model.backbone.stages)
    out = model(**_batch())
    sum(out[k].float().square().mean() for k in KEYS).backward()
    return out, {n: p.grad for n, p in model.named_parameters()}


def test_gdrn_remat_same_gradients():
    out0, g0 = _gdrn_grads(False)
    out1, g1 = _gdrn_grads(True)
    for k in KEYS:
        assert torch.equal(out0[k], out1[k]), k
    assert g0.keys() == g1.keys()
    for n in g0:
        assert g0[n] is not None and torch.equal(g0[n], g1[n]), n
    assert any(g0[n].abs().max() > 0 for n in g0 if ".mlp.fc1." in n)


def _backbone_grads(remat: bool, drop: DropMasks):
    m = ConvNeXt((1, 1, 2, 1), (16, 32, 48, 64), drop_path_rate=0.3, remat=remat).float()
    m.load_state_dict(seeded_state_dict(m, 5))
    m.train()
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 64, 64).astype(np.float32))
    m(x, drop).float().square().mean().backward()
    return {n: p.grad for n, p in m.named_parameters()}


def test_drop_path_masks_drawn_once():
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    g0 = _backbone_grads(False, DropMasks(gen=gens[0]))
    g1 = _backbone_grads(True, DropMasks(gen=gens[1]))
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    masks = [torch.rand((4, 1, 1, 1), generator=torch.Generator().manual_seed(i)) < 0.7
             for i in range(4)]    # block 0 has rate 0: no mask
    given = DropMasks(given=masks)
    g2 = _backbone_grads(True, given)
    assert not given.given
    g3 = _backbone_grads(False, DropMasks(given=masks))
    for n in g2:
        assert torch.equal(g2[n], g3[n]), n


def test_remat_is_training_only():
    m0 = ConvNeXt((1, 1, 2, 1), (16, 32, 48, 64)).float().eval()
    m1 = ConvNeXt((1, 1, 2, 1), (16, 32, 48, 64), remat=True).float().eval()
    sd = seeded_state_dict(m0, 3)
    m0.load_state_dict(sd)
    m1.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(m0(x), m1(x))
    assert m0.state_dict().keys() == m1.state_dict().keys()
