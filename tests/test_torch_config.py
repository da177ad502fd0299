"""Port parity: the port's own config copy equals the JAX package's.

``gdrnpp_bop2022_torch.config`` is a copy of ``gdrnpp_bop2022_tpu.config``
(the port imports nothing of the JAX package). ``Config()``, the YOLOX
config, overrides and ``parse_opts`` agree field by field, and the port's
``ycbv_convnext_base_rgbd()`` equals the ``cfg`` of
configs/gdrn/ycbv_convnext_base_rgbd.py.
"""

import dataclasses
import importlib.util
import os

import pytest

from gdrnpp_bop2022_tpu import config as jcfg
from gdrnpp_bop2022_torch import config as tcfg
from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(obj, prefix=""):
    """{dotted field path: (type name, value)} of a nested dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[prefix + f.name] = (type(v).__name__, None)
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = (type(v).__name__, v)
    return out


@pytest.mark.parametrize("name", ["Config", "YoloxConfig"])
def test_defaults_equal_jax(name):
    got, want = _fields(getattr(tcfg, name)()), _fields(getattr(jcfg, name)())
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_overrides_and_opts_equal_jax():
    opts = ["model.pose_net.num_classes=3", "solver.base_lr=1e-3",
            "datasets.test=('lm_test',)", "exp_name=run7", "model.pose_net.geo_head={'feat_dim': 32}"]
    assert tcfg.parse_opts(opts) == jcfg.parse_opts(opts)
    over = tcfg.parse_opts(opts)
    assert _fields(tcfg.replace_cfg(tcfg.Config(), over)) == \
        _fields(jcfg.replace_cfg(jcfg.Config(), over))
    with pytest.raises(KeyError):
        tcfg.replace_cfg(tcfg.Config(), {"model.no_such_field": 1})
    assert tcfg.iters_per_epoch(tcfg.Config(), 1000) == jcfg.iters_per_epoch(jcfg.Config(), 1000)


def test_rgbd_config_equals_the_config_file():
    path = os.path.join(_ROOT, "configs", "gdrn", "ycbv_convnext_base_rgbd.py")
    spec = importlib.util.spec_from_file_location("_rgbd_cfg_file", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got, want = _fields(ycbv_convnext_base_rgbd()), _fields(mod.cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    pc = ycbv_convnext_base_rgbd().model.pose_net
    assert pc.name == "gdrn_dstream_double_mask" and pc.fuse_type == "cat"
    assert ycbv_convnext_base_rgbd().val.use_depth_refine
