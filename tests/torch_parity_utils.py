"""Shared helpers for the PyTorch port's parity tests against the JAX package.

Parameters are drawn from a numpy seed at O(0.1-1) scale (the default
inits' 1e-6 layer scale and 1e-2..1e-3 head inits would make most layers
no-ops and the comparison nearly vacuous), pushed into the JAX model as
they are and into the port through ``state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gdrnpp_bop2022_tpu.config import Config, replace_cfg


def tiny_cfg(**overrides) -> Config:
    """``__graft_entry__._tiny_cfg()`` sizes: convnext_tiny, 64 -> 16,
    3 classes, feat 32, GN 8, fp32 compute, tanh GELU."""
    base = {
        "model.pose_net.num_classes": 3,
        "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16,
        "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32,
        "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8,
        "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8,
        "model.compute_dtype": "float32",
    }
    base.update(overrides)
    return replace_cfg(Config(), base)


def random_like_tree(template, seed: int):
    """numpy arrays shaped like ``template`` (a flax param tree or its
    ShapeDtypeStructs): kernels N(0, 1/fan_in), norm scales 1 + 0.1 N,
    biases 0.1 N, layer scales U(0.1, 0.5)."""
    rs = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, leaf in flat:
        name = str(path[-1].key)
        shape = tuple(leaf.shape)
        if name == "gamma":
            v = rs.uniform(0.1, 0.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) <= 1:
            v = 0.1 * rs.randn(*shape)
        else:
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        leaves.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jax_gdrn_params(cfg: Config, seed: int = 0):
    """(jax model, random numpy params) for ``cfg``; the template comes
    from ``jax.eval_shape``, so no initialisation runs."""
    from gdrnpp_bop2022_tpu.models import build_gdrn
    from gdrnpp_bop2022_tpu.utils.fake_data import fake_gdrn_batch

    pc = cfg.model.pose_net
    model = build_gdrn(cfg)
    fb = fake_gdrn_batch(2, pc.input_res, pc.output_res, pc.num_classes,
                         pc.geo_head.num_regions, num_points=8)
    keys = ("roi_img", "roi_labels", "roi_coord_2d", "roi_cams", "roi_centers",
            "roi_whs", "roi_extents", "resize_ratios")
    args = [jnp.asarray(fb[k]) for k in keys]
    if "dstream" in pc.name:        # the depth stream's backprojected ROI
        args.append(jnp.zeros((2, pc.input_res, pc.input_res, 3), jnp.float32))
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, *args),
                            jax.random.PRNGKey(0))["params"]
    return model, random_like_tree(shapes, seed)


def port_gdrn(cfg: Config, params) -> torch.nn.Module:
    """The port's GDRN for ``cfg`` holding the JAX params, strict-loaded."""
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.utils.weights import state_dict_from_flax

    model = build_gdrn(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    return model


def roi_batch(cfg: Config, B: int, seed: int = 0) -> dict:
    """A random model-input batch (numpy, the JAX package's layout)."""
    pc = cfg.model.pose_net
    rs = np.random.RandomState(seed)
    R, r = pc.input_res, pc.output_res
    return {
        "roi_img": rs.randn(B, R, R, 3).astype(np.float32),
        "roi_labels": rs.randint(0, pc.num_classes, B).astype(np.int32),
        "roi_coord_2d": rs.rand(B, r, r, 2).astype(np.float32),
        "roi_cams": np.tile(np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]],
                                     np.float32), (B, 1, 1)),
        "roi_centers": rs.uniform(100, 400, (B, 2)).astype(np.float32),
        "roi_whs": rs.uniform(40, 120, (B, 2)).astype(np.float32),
        "roi_extents": rs.uniform(0.05, 0.2, (B, 3)).astype(np.float32),
        "resize_ratios": rs.uniform(0.3, 1.0, B).astype(np.float32),
    }


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
