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
        leaves.append(np.asarray(v, np.float32))     # scalar leaves: randn() is a float
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
    # backbone.in_channels: 6 for early RGB-D fusion
    args[0] = jnp.zeros(args[0].shape[:3] + (pc.backbone.in_channels,), jnp.float32)
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


def flax_params_from_port(sd: dict, cfg: Config, template: dict) -> dict:
    """The port's state dict (numpy arrays) as the JAX package's parameter
    tree: the JAX package's ``convert_gdrn_checkpoint`` for the network
    (both backbones of the dual stream included), and the top-level
    ``log_var_*`` scalars of ``loss.use_mtl`` under their own names."""
    from gdrnpp_bop2022_tpu.models.gdrn import xyz_mask_region_out_dims
    from gdrnpp_bop2022_tpu.utils.torch_port import convert_gdrn_checkpoint
    from gdrnpp_bop2022_torch.models.heads.conv_pnp_net import final_spatial

    pc = cfg.model.pose_net
    xyz, mask, region = xyz_mask_region_out_dims(pc)
    depths = {"convnext_tiny": (3, 3, 9, 3)}.get(pc.backbone.name, (3, 3, 27, 3))
    net = {k: v for k, v in sd.items() if not k.startswith("log_var_")}
    out = convert_gdrn_checkpoint(
        net, template, depths=depths, up_types=pc.geo_head.up_types,
        num_conv_per_block=pc.geo_head.num_conv_per_block,
        num_stride2_layers=pc.pnp_net.num_stride2_layers,
        num_extra_layers=pc.pnp_net.num_extra_layers, flat_op=pc.pnp_net.flat_op,
        final_spatial=final_spatial(pc.output_res, pc.pnp_net.num_stride2_layers),
        mask_out_dim=mask, xyz_out_dim=xyz, region_out_dim=region, num_classes=pc.num_classes)
    out.update({k: np.asarray(v, np.float32) for k, v in sd.items() if k.startswith("log_var_")})
    return out


def roi_batch(cfg: Config, B: int, seed: int = 0) -> dict:
    """A random model-input batch (numpy, the JAX package's layout)."""
    pc = cfg.model.pose_net
    rs = np.random.RandomState(seed)
    R, r = pc.input_res, pc.output_res
    return {
        "roi_img": rs.randn(B, R, R, pc.backbone.in_channels).astype(np.float32),
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


# ---------------------------------------------------------------------------
# YOLOX
# ---------------------------------------------------------------------------

def yolox_images(size, seed=1, n=2):
    # uniform noise: no symmetry a wrong Focus order or flip could hide behind
    return np.random.RandomState(seed).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def _random_stats(template, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: (rs.uniform(0.5, 2.0, leaf.shape) if str(path[-1].key) == "var"
                            else 0.1 * rs.randn(*leaf.shape)).astype(np.float32), template)


def jax_yolox(norm, depthwise, wid, size, seed=0, nc=3):
    """(JAX model in fp32, params, batch_stats or None) drawn from a seed."""
    from gdrnpp_bop2022_tpu.models.yolox.yolox import YOLOX as JaxYOLOX
    jm = JaxYOLOX(num_classes=nc, dep_mul=0.33, wid_mul=wid, norm=norm,
                  depthwise=depthwise, remat=False, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, size, size, 3))),
                            jax.random.PRNGKey(0))
    params = random_like_tree(shapes["params"], seed)
    stats = _random_stats(shapes["batch_stats"], seed + 1) if norm == "BN" else None
    return jm, params, stats


def jax_apply(jm, params, stats, x):
    v = {"params": params} if stats is None else {"params": params, "batch_stats": stats}
    return [np.asarray(o) for o in jax.jit(jm.apply)(v, jnp.asarray(x))]


def port_yolox(norm, depthwise, wid, sd, nc=3):
    from gdrnpp_bop2022_torch.models.yolox.yolox import YOLOX
    m = YOLOX(nc, 0.33, wid, depthwise=depthwise, norm=norm, dtype=torch.float32).eval()
    m.load_state_dict(sd, strict=True)
    return m


def port_apply(m, x):
    with torch.no_grad():
        return [o.numpy() for o in m(torch.from_numpy(x))]


def assert_rows_match(want_labels, want_scores, want_boxes, got_labels, got_scores,
                      got_boxes, score_tol, box_tol):
    """Two sets of detections hold the same rows: every wanted row has its
    own got row of the same label with the score within score_tol and the
    box within box_tol. Order is free (scores that tie within the tolerance
    may come out in either order)."""
    assert len(want_labels) == len(got_labels)
    free = np.ones(len(got_labels), bool)
    for lab, s, b in zip(want_labels, want_scores, want_boxes):
        hit = np.nonzero(free & (np.asarray(got_labels) == lab)
                         & (np.abs(np.asarray(got_scores) - s) <= score_tol)
                         & (np.abs(np.asarray(got_boxes) - b).max(-1) <= box_tol))[0]
        assert len(hit), f"no match for label {lab} score {s} box {b}"
        free[hit[0]] = False
