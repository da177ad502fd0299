"""GDRN training, on one card or one process per card.

The port's counterpart of ``tools/train_gdrn.py`` (reference
core/gdrn_modeling/main_gdrn.py + train_gdrn.sh):

    python -m gdrnpp_bop2022_torch.tools.train_gdrn --config ycbv_convnext_base \
        [--opts solver.base_lr=1e-4 ...] [--max-iters N] \
        [--resume] [--eval-only] [--device cpu]

``--config`` is ``default`` (``Config()``) or a name from
``gdrnpp_bop2022_torch/configs.py``; ``--opts key=value`` overrides it.
Trains on ``datasets.train`` (BOP splits under ``datasets.root``), writes
``metrics.json``, TensorBoard scalars and checkpoints under ``output_dir``.
The model bank is read with ``num_fps = geo_head.num_regions`` and
``max_faces = pose_net.gt_max_faces``. With ``train.eval_period > 0`` and
``datasets.det_files_test``, the EMA weights (or the weights, without
``model.ema_enabled``) are scored periodically on ``datasets.test`` through
``run_gdrn_inference`` + ``score_bop_results`` (mssd, mspd), with depth
ROIs for an RGB-D config.
``--eval-only`` serves and scores the newest checkpoint with
``tools.test_gdrn.run_eval``. Runs on the card unless ``--device cpu``.

Data parallel, one process per card (``cfg.train.mesh_shape``, the global
batch ``solver.ims_per_batch`` split over the ranks)::

    torchrun --nproc_per_node 4 -m gdrnpp_bop2022_torch.tools.train_gdrn \
        --config ycbv_convnext_base

or ``--num-processes N --process-id R --coordinator host:port`` in each
process; ``--dist-backend gloo`` lets two ranks share one card (with
``--device cuda:0``). Each rank writes ``stats_rank<R>.json`` under
``output_dir``: its kernel launches, steps and peak card memory.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..datasets.meta import register_meta_files
from ..parallel.distributed import add_distributed_args, barrier, init_from_args, shutdown


def records_for(cfg, meta, names):
    from ..datasets.bop_data import index_bop_split
    recs = []
    for name in names:
        split = name.split("_", 1)[1] if "_" in name else "train"
        recs.extend(index_bop_split(
            os.path.join(cfg.datasets.root, meta.name, split), meta,
            visib_thr=cfg.datasets.filter_visib_thr,
            cache_path=os.path.join(cfg.output_dir, f"index_{name}.pkl")))
    return recs


def make_eval_fn(cfg, meta, bank, device):
    """eval_fn(state, iteration) -> {AR, AR_mssd, AR_mspd, ...} on the test
    split's detections (reference periodic do_test, engine.py:345-363)."""
    from ..datasets.bop_data import index_bop_split, load_detections, make_records_by_image
    from ..datasets.test_loader import iter_test_batches
    from ..engine.inference import run_gdrn_inference
    from ..eval.scorer import score_bop_results
    from ..models.gdrn import build_gdrn

    test_name = cfg.datasets.test[0]
    split = test_name.split("_", 1)[1] if "_" in test_name else "test"
    test_records = index_bop_split(os.path.join(cfg.datasets.root, meta.name, split), meta)
    by_im = make_records_by_image(test_records)
    dets = load_detections(cfg.datasets.det_files_test[0], meta,
                           top_k_per_obj=cfg.datasets.det_topk_per_obj,
                           score_thr=cfg.datasets.det_thr)
    gt_rows = [{"scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
                "R": r.pose[:, :3], "t": r.pose[:, 3], "visib_fract": r.visib_fract}
               for r in test_records if r.pose is not None]
    pc = cfg.model.pose_net
    eval_model = build_gdrn(cfg, device=device)

    def eval_fn(state, iteration):
        eval_model.load_state_dict(state.ema_state_dict() if cfg.model.ema_enabled
                                   else state.model.state_dict(), strict=True)
        # RGB-D models take depth ROIs at evaluation too (reference
        # data_loader.py:522-533)
        results = run_gdrn_inference(
            eval_model, iter_test_batches(by_im, dets, batch_size=64,
                                          with_depth=cfg.input.with_depth,
                                          depth_factor=meta.depth_factor),
            bank.extents, input_res=pc.input_res, output_res=pc.output_res,
            pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
            with_depth_input=cfg.input.with_depth, bp_depth=cfg.input.bp_depth,
            coord_2d_type=pc.pnp_net.coord_2d_type)
        scores = score_bop_results(results, gt_rows, bank, im_width=meta.width,
                                   errors=("mssd", "mspd"), device=device)
        return {k: v for k, v in scores.items()
                if k in ("AR", "AR_mssd", "AR_mspd", "add_10", "re_5")}

    return eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default' (Config()) or a name from configs.py")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dataset-meta", nargs="+", default=[],
                    help="JSON files of datasets to register first (datasets/meta.py::"
                         "register_meta_file)")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    register_meta_files(args.dataset_meta)
    rank, world, args.device = init_from_args(args)
    try:
        return _run(args, rank, world)
    finally:
        if world > 1:
            shutdown()


def _run(args, rank: int, world: int):

    from ..bop.models3d import ModelBank
    from ..config import parse_opts, replace_cfg
    from ..datasets.meta import get_meta
    from .test_gdrn import load_config

    cfg = load_config(args.config)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    os.makedirs(cfg.output_dir, exist_ok=True)
    meta = get_meta(cfg.datasets.test[0] if args.eval_only else cfg.datasets.train[0])
    bank = ModelBank.from_bop_models_dir(
        meta.models_dir(cfg.datasets.root), num_fps=cfg.model.pose_net.geo_head.num_regions,
        max_faces=cfg.model.pose_net.gt_max_faces)

    if args.eval_only:
        from ..engine.checkpoint import CheckpointManager
        from ..models.gdrn import build_gdrn
        from .test_gdrn import run_eval
        mgr = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
        payload = torch.load(mgr.path(step), map_location="cpu", weights_only=False)
        model = build_gdrn(cfg, device=args.device)
        model.load_state_dict(payload["ema"] if cfg.model.ema_enabled else payload["model"],
                              strict=True)
        return run_eval(cfg, meta, bank, model, device=args.device)

    from ..engine.trainer import train_gdrn
    if rank > 0:        # rank 0 writes the split's index cache first
        barrier()
    records = records_for(cfg, meta, cfg.datasets.train)
    records2 = records_for(cfg, meta, cfg.datasets.train2) if cfg.datasets.train2 else None
    if rank == 0 and world > 1:
        barrier()
    eval_fn = None
    if rank == 0 and cfg.train.eval_period > 0 and cfg.datasets.det_files_test:
        eval_fn = make_eval_fn(cfg, meta, bank, args.device)
    state = train_gdrn(cfg, records, bank, records2=records2, max_iters=args.max_iters,
                       resume=args.resume, meta=meta, eval_fn=eval_fn, device=args.device)
    _write_stats(os.path.join(cfg.output_dir, f"stats_rank{rank}.json"), rank, world, state,
                 args.device)
    return state


def _write_stats(path: str, rank: int, world: int, state, device) -> None:
    """This process's kernel launches, steps and peak card memory."""
    import json
    from ..ops.layer_norm import layer_norm, layer_norm_backward
    from ..ops.raster import render_depth_xyz_cuda
    on_card = torch.device(device).type == "cuda"
    with open(path, "w") as f:
        json.dump({"rank": rank, "world": world, "steps": state.step,
                   "launches": {"layer_norm": layer_norm.launches,
                                "layer_norm_backward": layer_norm_backward.launches,
                                "render_depth_xyz": render_depth_xyz_cuda.launches},
                   "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card
                   else None}, f)


if __name__ == "__main__":
    main()
