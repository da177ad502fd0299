"""Port parity: the port's own config copy equals the JAX package's.

``gdrnpp_bop2022_torch.config`` is a copy of ``gdrnpp_bop2022_tpu.config``
(the port imports nothing of the JAX package). ``Config()``, the YOLOX
config, overrides and ``parse_opts`` agree field by field, and the port's
``ycbv_convnext_base_rgbd()`` and ``ycbv_convnext_base()`` equal the ``cfg``
of configs/gdrn/ycbv_convnext_base_rgbd.py and configs/gdrn/ycbv_convnext_base.py,
each other dataset's ``<ds>_convnext_base()`` the ``cfg`` of
configs/gdrn/<ds>_convnext_base.py, each per-object ``so("ycbv", obj)`` the
``cfg`` of configs/gdrn/ycbvSO/<obj>.py (what tools/gen_so_configs.py wrote;
``tools/test_gdrn.py::load_config`` resolves ``ycbvSO/<obj>`` to it), and
each detector recipe ``yolox(name)`` the ``cfg`` of configs/yolox/<name>.py.
"""

import dataclasses
import glob
import importlib.util
import os

import pytest

from gdrnpp_bop2022_tpu import config as jcfg
from gdrnpp_bop2022_torch import config as tcfg
from gdrnpp_bop2022_torch import configs
from gdrnpp_bop2022_torch.configs import (YOLOX_RECIPES, ycbv_convnext_base,
                                          ycbv_convnext_base_rgbd, yolox)
from gdrnpp_bop2022_torch.tools.test_gdrn import load_config

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


def _config_file(name):
    path = os.path.join(_ROOT, "configs", "gdrn", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name.replace('/', '_')}_cfg_file", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cfg


_CORE = ("lm", "lmo", "tless", "tudl", "icbin", "itodd", "hb")


def test_gdrn_recipes_are_the_config_files():
    files = {os.path.basename(f)[:-3]
             for f in glob.glob(os.path.join(_ROOT, "configs", "gdrn", "*_convnext_base*.py"))}
    assert files == set(configs.GDRN_CONFIGS)


@pytest.mark.parametrize("ds", _CORE)
def test_dataset_recipe_equals_the_config_file(ds):
    name = f"{ds}_convnext_base"
    got, want = _fields(load_config(name)), _fields(_config_file(name))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_so_configs_are_the_generated_files():
    files = sorted(os.path.basename(f)[:-3]
                   for f in glob.glob(os.path.join(_ROOT, "configs", "gdrn", "ycbvSO", "*.py")))
    assert files == sorted(configs.so_objects("ycbv")) and len(files) == 21
    with pytest.raises(ValueError, match="not an object of ycbv"):
        configs.so("ycbv", "no_such_object")


@pytest.mark.parametrize("obj", sorted(
    os.path.basename(f)[:-3] for f in glob.glob(os.path.join(_ROOT, "configs", "gdrn", "ycbvSO",
                                                              "*.py"))))
def test_so_config_equals_the_generated_file(obj):
    got, want = _fields(load_config(f"ycbvSO/{obj}")), _fields(_config_file(f"ycbvSO/{obj}"))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_rgbd_config_equals_the_config_file():
    got, want = _fields(ycbv_convnext_base_rgbd()), _fields(_config_file("ycbv_convnext_base_rgbd"))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    pc = ycbv_convnext_base_rgbd().model.pose_net
    assert pc.name == "gdrn_dstream_double_mask" and pc.fuse_type == "cat"
    assert ycbv_convnext_base_rgbd().val.use_depth_refine


def test_training_config_equals_the_config_file():
    got, want = _fields(ycbv_convnext_base()), _fields(_config_file("ycbv_convnext_base"))
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    cfg = ycbv_convnext_base()
    pc = cfg.model.pose_net
    assert (pc.backbone.name, pc.num_classes, pc.input_res, pc.output_res) == \
        ("convnext_base", 21, 256, 64)
    assert (cfg.solver.ims_per_batch, cfg.solver.base_lr, cfg.solver.optimizer) == \
        (48, 8e-4, "ranger")
    assert pc.xyz_online and pc.xyz_bp and cfg.model.compute_dtype == "bfloat16"


def test_yolox_recipes_are_the_config_files():
    files = {os.path.basename(f)[:-3]
             for f in glob.glob(os.path.join(_ROOT, "configs", "yolox", "[a-z]*.py"))}
    assert files == set(YOLOX_RECIPES)


@pytest.mark.parametrize("name", YOLOX_RECIPES)
def test_yolox_recipe_equals_the_config_file(name):
    path = os.path.join(_ROOT, "configs", "yolox", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_yolox_{name}_cfg_file", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got, want = _fields(yolox(name)), _fields(mod.cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
