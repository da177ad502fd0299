"""Port parity: the geo head and ConvPnPNet against the JAX package.

fp32 on the CPU, parameters from a numpy seed, pushed into the port by the
same bridge as the whole model (utils/weights.py). The geo head is checked
on the class-aware weight-gather path (k = 1 with labels), on the
full-conv path (k = 3) and without class awareness; the PnP net with each
flatten mode and mask attention. Tolerance 1e-4 relative to each output's
scale: a few conv/GroupNorm layers in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.config import GeoHeadConfig, PnPNetConfig
from gdrnpp_bop2022_tpu.models.heads.conv_pnp_net import ConvPnPNet as JPnP
from gdrnpp_bop2022_tpu.models.heads.top_down_head import (
    TopDownDoubleMaskXyzRegionHead as JHead)
from gdrnpp_bop2022_torch.models.heads.conv_pnp_net import ConvPnPNet
from gdrnpp_bop2022_torch.models.heads.top_down_head import (
    TopDownDoubleMaskXyzRegionHead)
from gdrnpp_bop2022_torch.utils.weights import _geo_head, _pnp_net
from torch_parity_utils import random_like_tree


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


def _tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.mark.parametrize("case", ["gather", "conv3", "agnostic", "binned_bilinear"])
def test_geo_head_matches_jax(case):
    nc = 1 if case == "agnostic" else 3
    k = 3 if case == "conv3" else 1
    up_types = (("bilinear", "bilinear", "deconv") if case == "binned_bilinear"
                else ("deconv", "bilinear", "bilinear"))
    xyz_dim = 3 * 5 if case == "binned_bilinear" else 3
    gh = GeoHeadConfig(up_types=up_types, feat_dim=32, num_gn_groups=8,
                       out_kernel_size=k, num_regions=8)
    kw = dict(up_types=up_types, feat_dim=32, num_gn_groups=8,
              out_kernel_size=k, mask_num_classes=nc, xyz_num_classes=nc,
              region_num_classes=nc, mask_out_dim=2, xyz_out_dim=xyz_dim,
              region_out_dim=9)
    jh = JHead(dtype=jnp.float32, **kw)
    rs = np.random.RandomState(0)
    x = rs.randn(3, 4, 4, 48).astype(np.float32)
    labels = np.array([2, 0, 1], np.int32) % nc
    shapes = jax.eval_shape(lambda r: jh.init(r, jnp.asarray(x), jnp.asarray(labels)),
                            jax.random.PRNGKey(0))["params"]
    params = random_like_tree(shapes, 1)
    want = jh.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels))

    th = TopDownDoubleMaskXyzRegionHead(48, dtype=torch.float32, **kw).eval()
    th.load_state_dict(_tensors(_geo_head(params, gh, (xyz_dim, 2, 9), nc)),
                       strict=True)
    with torch.no_grad():
        got = th(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(labels))
    for name in ("vis_mask", "full_mask", "coor_x", "coor_y", "coor_z", "region"):
        assert got[name].dtype == torch.float32
        _close(got[name].permute(0, 2, 3, 1).numpy(), want[name])


@pytest.mark.parametrize("flat_op,mask_attention,extra", [
    ("flatten", "none", 0), ("avg-max", "mul", 1), ("flatten", "concat", 0)])
def test_conv_pnp_net_matches_jax(flat_op, mask_attention, extra):
    pn = PnPNetConfig(featdim=32, num_gn_groups=8, flat_op=flat_op,
                      mask_attention=mask_attention, num_extra_layers=extra)
    jn = JPnP(featdim=32, num_gn_groups=8, flat_op=flat_op,
              mask_attention=mask_attention, num_extra_layers=extra,
              dtype=jnp.float32)
    rs = np.random.RandomState(2)
    B, r = 3, 16
    coor = rs.rand(B, r, r, 5).astype(np.float32)
    region = rs.rand(B, r, r, 8).astype(np.float32)
    ext = rs.uniform(0.05, 0.2, (B, 3)).astype(np.float32)
    matt = rs.rand(B, r, r, 1).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (coor, region, ext, matt)]
    shapes = jax.eval_shape(lambda k: jn.init(k, *jargs),
                            jax.random.PRNGKey(0))["params"]
    params = random_like_tree(shapes, 3)
    rot_j, t_j = jn.apply({"params": params}, *jargs)

    in_c = 5 + 8 + (1 if mask_attention == "concat" else 0)
    tn = ConvPnPNet(in_c, featdim=32, num_gn_groups=8, flat_op=flat_op,
                    mask_attention=mask_attention, num_extra_layers=extra,
                    output_res=r, dtype=torch.float32).eval()
    tn.load_state_dict(_tensors(_pnp_net(params, pn, r)), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        rot_t, t_t = tn(nchw(coor), nchw(region), torch.from_numpy(ext), nchw(matt))
    assert rot_t.dtype == torch.float32 and rot_t.shape == (B, 6)
    _close(rot_t.numpy(), rot_j)
    _close(t_t.numpy(), t_j)
