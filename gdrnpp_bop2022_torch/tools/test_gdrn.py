"""GDRN evaluation: detections -> poses -> BOP CSV -> scores, on one card or over processes.

The port's counterpart of ``tools/test_gdrn.py`` (reference test_gdrn.sh ->
main_gdrn.py --eval-only):

    python -m gdrnpp_bop2022_torch.tools.test_gdrn --config ycbv_convnext_base_rgbd \
        --weights model_final.pth [--opts val.use_pnp=True ...] [--device cpu]

``--config`` is ``default`` (the flagship ``Config()``), a GDRN recipe of
``gdrnpp_bop2022_torch/configs.py`` (``ycbv_convnext_base``,
``lmo_convnext_base``, ...) or a per-object config ``<dataset>SO/<obj>``
(``ycbvSO/002_master_chef_can``); ``--opts key=value`` overrides it.
Weights come from a ``.pth`` state dict with the reference's (timm) names,
or from ``--seed N`` (random weights drawn from a seed). Writes
``<output_dir>/inference/<test dataset>/poses.csv`` (BOP19),
``scores.json`` and ``stats.json`` (ROIs, forwards, ROI/s, and the kernel
launches: B1's while serving, B2's while scoring) and prints the scores.

Several processes (``--num-processes N --process-id R --coordinator
host:port``, or torchrun): the test images are dealt round-robin over
their sorted keys (image i to rank i % N), each rank serves its share, the
rows are gathered over gloo (so ranks may share one card), and rank 0
alone writes ``poses.csv`` (rank order), scores and ``stats.json`` (counts
summed over the ranks); the other ranks return their gathered rows.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..datasets.meta import register_meta_files
from ..parallel.distributed import (add_distributed_args, gather_results, init_from_args,
                                    is_main_process, rank, shutdown, world_size)

PNP_TYPES = ("ransac_pnp", "uncertainty_pnp", "net_iter_pnp")


def load_config(name: str):
    """'default' (``Config()``), a recipe of ``configs.GDRN_CONFIGS`` or a
    per-object config ``<dataset>SO/<obj>`` (``configs.so``)."""
    from .. import configs
    from ..config import Config
    if name == "default":
        return Config()
    if "SO/" in name:
        return configs.so(*name.split("SO/", 1))
    if name not in configs.GDRN_CONFIGS:
        raise ValueError(f"--config {name!r}: 'default', <dataset>SO/<obj> or a GDRN "
                         f"config of gdrnpp_bop2022_torch/configs.py "
                         f"({', '.join(configs.GDRN_CONFIGS)})")
    return configs.GDRN_CONFIGS[name]()


def post_mode_of(cfg) -> str:
    """The evaluator's post-processing (reference GDRN_Evaluator.process
    branches, gdrn_evaluator.py:180/241/373/461)."""
    if cfg.val.use_depth_refine:
        return "depth_refine"
    if cfg.val.use_pnp:
        if cfg.val.pnp_type not in PNP_TYPES:
            raise ValueError(f"val.pnp_type={cfg.val.pnp_type!r}: expected one of {PNP_TYPES}")
        return cfg.val.pnp_type
    return "direct"


def run_eval(cfg, meta, bank, model, device="cuda", seed: int = 0):
    """Serve the config's test split with ``model`` and score the result.
    Returns (results, scores or None)."""
    from ..bop.inout import load_test_targets, save_bop_results, save_json
    from ..datasets.bop_data import (gt_detections, index_bop_split, load_depth,
                                     load_detections, make_records_by_image)
    from ..datasets.test_loader import iter_test_batches
    from ..engine.inference import results_to_bop_rows, run_gdrn_inference
    from ..eval.scorer import score_bop_results

    test_name = cfg.datasets.test[0]
    split = test_name.split("_", 1)[1] if "_" in test_name else "test"
    split_dir = os.path.join(cfg.datasets.root, meta.name, split)
    records = index_bop_split(split_dir, meta)
    by_im = make_records_by_image(records)
    served = by_im
    if world_size() > 1:
        keys = sorted(by_im)
        served = {k: by_im[k] for i, k in enumerate(keys) if i % world_size() == rank()}
    if cfg.model.load_dets_test:
        if not cfg.datasets.det_files_test:
            raise ValueError("model.load_dets_test needs datasets.det_files_test")
        dets = load_detections(cfg.datasets.det_files_test[0], meta,
                               top_k_per_obj=cfg.datasets.det_topk_per_obj,
                               score_thr=cfg.datasets.det_thr)
    else:
        # the reference default (gdrn_base.py:10): test on the GT boxes
        dets = gt_detections(records, bbox_type=cfg.model.bbox_type)

    from ..ops.layer_norm import layer_norm
    from ..ops.raster import render_depth_xyz_cuda

    pc = cfg.model.pose_net
    post_mode = post_mode_of(cfg)
    forwards = [0]
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    ln0 = layer_norm.launches
    batches = iter_test_batches(served, dets, batch_size=64,
                                with_depth=post_mode == "depth_refine" or cfg.input.with_depth,
                                depth_factor=meta.depth_factor)
    stats = {}
    try:
        results = run_gdrn_inference(
            model, batches, bank.extents, input_res=pc.input_res, output_res=pc.output_res,
            pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
            post_mode=post_mode, model_bank=bank,
            depth_refine_iters=cfg.val.depth_refine_iters,
            depth_refine_threshold=cfg.val.depth_refine_threshold,
            mask_loss_type=pc.loss.mask_loss_type, with_depth_input=cfg.input.with_depth,
            bp_depth=cfg.input.bp_depth, coord_2d_type=pc.pnp_net.coord_2d_type, seed=seed,
            stats=stats)
    finally:
        hook.remove()
    run = {"n_rois": len(results), "forwards": forwards[0],
           "launches": {"layer_norm": layer_norm.launches - ln0}}
    run.update({k: stats[k] for k in ("n_batches", "rois_per_sec", "p50_ms", "p99_ms")
                if k in stats})
    if stats["n_batches"]:
        print(f"served {stats['n_instances']} ROIs in {stats['n_batches']} batches of 64 "
              f"({post_mode}, {stats['device']}): {stats['rois_per_sec']:.1f} ROI/s, p50 "
              f"{stats['p50_ms']:.2f} ms a batch")
    if world_size() > 1:
        results = gather_results(results)
        runs = gather_results([run])
        if not is_main_process():
            return results, None
        run = {"n_rois": len(results), "forwards": sum(r["forwards"] for r in runs),
               "launches": {"layer_norm": sum(r["launches"]["layer_norm"] for r in runs)},
               "n_batches": sum(r.get("n_batches", 0) for r in runs), "processes": len(runs)}

    out_dir = os.path.join(cfg.output_dir, "inference", test_name)
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "poses.csv")
    save_bop_results(csv_path, results_to_bop_rows(results))
    print(f"wrote {len(results)} poses -> {csv_path}")
    stats_path = os.path.join(out_dir, "stats.json")
    save_json(stats_path, run)
    if cfg.val.save_results_only:
        print("val.save_results_only=True: skipping scoring")
        return results, None

    gt_rows = [{"scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
                "R": r.pose[:, :3], "t": r.pose[:, 3], "visib_fract": r.visib_fract}
               for r in records if r.pose is not None]
    if not gt_rows:
        return results, None
    targets_path = os.path.join(cfg.datasets.root, meta.name, cfg.val.targets_filename)
    targets = load_test_targets(targets_path) if os.path.exists(targets_path) else None

    def depth_getter(scene_id, im_id):
        p = os.path.join(split_dir, f"{scene_id:06d}", "depth", f"{im_id:06d}.png")
        if not os.path.exists(p):
            return None
        rec = by_im.get(f"{scene_id}/{im_id}")
        return load_depth(p, rec["depth_scale"] if rec else 1.0, meta.depth_factor)

    # DATASETS.SYM_OBJS: the config's, else the dataset's
    sym_names = cfg.datasets.sym_objs or meta.sym_objs
    obj_id_to_label, obj2id = meta.obj_id_to_label(), meta.obj2id
    sym_labels = [obj_id_to_label[obj2id[n]] for n in sym_names
                  if n in obj2id and obj2id[n] in obj_id_to_label]
    err_types = tuple(e.strip() for e in cfg.val.error_types.split(",") if e.strip())
    bad = set(err_types) - {"vsd", "mssd", "mspd"}
    if bad:
        raise ValueError(f"val.error_types: unknown {sorted(bad)}")
    r0 = render_depth_xyz_cuda.launches
    scores = score_bop_results(
        results, gt_rows, bank, targets=targets, im_width=meta.width,
        depth_test_getter=depth_getter, vsd_mode=cfg.val.vsd_mode, errors=err_types,
        eval_precision=cfg.val.eval_precision, sym_obj_labels=sym_labels,
        vsd_delta=meta.vsd_delta, n_top=cfg.val.n_top, visib_gt_min=meta.visib_gt_min,
        device=device)
    run["launches"]["render_depth_xyz"] = render_depth_xyz_cuda.launches - r0
    save_json(stats_path, run)
    save_json(os.path.join(out_dir, "scores.json"), scores)
    print(json.dumps(scores, indent=2))
    return results, scores


def weights_to_serve(payload: dict, ema_enabled: bool) -> dict:
    """The state dict to serve from a loaded ``--weights`` file: a training
    checkpoint's EMA weights when it has them and ``model.ema_enabled`` is
    set (as the JAX tools/test_gdrn.py serves ``ema_params``), else its
    ``model`` weights; a plain state dict as it is."""
    if ema_enabled and "ema" in payload:
        return payload["ema"]
    return payload.get("model", payload)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default' (Config()) or a name from configs.py")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    w = ap.add_mutually_exclusive_group(required=True)
    w.add_argument("--weights", help="a .pth state dict with the reference's names")
    w.add_argument("--seed", type=int, help="random weights drawn from this seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dataset-meta", nargs="+", default=[],
                    help="JSON files of datasets to register first (datasets/meta.py::"
                         "register_meta_file)")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    register_meta_files(args.dataset_meta)
    # the ranks exchange host rows only: gloo unless asked otherwise
    _, world, args.device = init_from_args(args, backend="gloo")
    try:
        return _run(args)
    finally:
        if world > 1:
            shutdown()


def _run(args):

    from ..bop.models3d import ModelBank
    from ..config import parse_opts, replace_cfg
    from ..datasets.meta import get_meta
    from ..models.gdrn import build_gdrn
    from ..utils.weights import seeded_state_dict

    cfg = load_config(args.config)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    meta = get_meta(cfg.datasets.test[0])
    models_eval = meta.models_dir(cfg.datasets.root, "models_eval")
    bank = ModelBank.from_bop_models_dir(
        models_eval if os.path.isdir(models_eval) else meta.models_dir(cfg.datasets.root),
        num_fps=cfg.model.pose_net.geo_head.num_regions)
    model = build_gdrn(cfg, device=args.device)
    if args.weights:
        sd = weights_to_serve(torch.load(args.weights, map_location="cpu"),
                              cfg.model.ema_enabled)
    else:
        sd = seeded_state_dict(model, args.seed)
    model.load_state_dict(sd, strict=True)
    return run_eval(cfg, meta, bank, model, device=args.device,
                    seed=0 if args.seed is None else args.seed)


if __name__ == "__main__":
    main()
