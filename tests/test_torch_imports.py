"""The port imports torch and never jax, nor anything of the JAX package.

A fresh interpreter imports every module of ``gdrnpp_bop2022_torch``;
no ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``gdrnpp_bop2022_tpu``
module may appear in ``sys.modules`` afterwards.
"""

import json
import os
import subprocess
import sys

_PROBE = r"""
import importlib, json, pkgutil, sys
import gdrnpp_bop2022_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "gdrnpp_bop2022_tpu"))
print(json.dumps({"modules": names, "jax": bad}))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] == [], out["jax"]
    for m in ("geometry.rotations", "geometry.se3", "ops.layer_norm", "ops.crop",
              "models.layers", "models.backbones.convnext",
              "models.backbones.resnet", "models.backbones.resnest",
              "models.heads.top_down_head", "models.heads.conv_pnp_net",
              "models.heads.point_pnp_net",
              "models.gdrn", "engine.batching", "engine.inference",
              "datasets.test_loader", "datasets.bop_data", "datasets.meta",
              "bop.inout", "utils.weights", "utils.cuda_build", "config",
              "configs", "utils.channel_perm", "geometry.camera",
              "geometry.symmetry", "bop.models3d", "ops.rasterizer", "ops.raster",
              "eval.pnp_eval", "eval.pose_error", "eval.vsd", "eval.scorer", "ops.pnp",
              "tools.score_csv", "tools.test_gdrn", "ops.region", "losses.gdrn_losses",
              "solver.lr_scheduler", "solver.ranger", "engine.train_state",
              "engine.train_step", "engine.checkpoint", "engine.trainer",
              "datasets.train_loader", "utils.tb_writer", "utils.vis", "tools.train_gdrn",
              "ops.color_space", "ops.color_aug", "ops.depth_aug", "datasets.device_pool",
              "solver.optimizers", "models.yolox", "models.yolox.darknet",
              "models.yolox.pafpn", "models.yolox.head", "models.yolox.yolox",
              "datasets.yolox_loader", "eval.detection_eval", "tools.test_yolox",
              "tools.demo_yolox", "tools.demo_gdrn", "engine.yolox_trainer",
              "tools.train_yolox", "ops.fps", "ops.chamfer", "ops.flow", "ops.edges",
              "ops.ransac_voting", "utils.mask_rle", "utils.fake_data", "tools.export_model",
              "tools.strip_ckpt", "tools.convert_dets", "tools.merge_so_results",
              "tools.process_results_time", "tools.run_bop_sweep", "tools.compute_mask_miou",
              "tools.vis_dataset", "parallel", "parallel.mesh", "parallel.distributed"):
        assert f"gdrnpp_bop2022_torch.{m}" in out["modules"], m
