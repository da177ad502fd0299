"""YOLOX evaluation on one card: a BOP split -> detections -> the handoff json.

The port's counterpart of ``tools/test_yolox.py`` (reference
det/yolox/tools/main_yolox.py --eval-only -> convert_to_coco_format_bop, the
stage-1 -> stage-2 handoff):

    python -m gdrnpp_bop2022_torch.tools.test_yolox --config ycbv \\
        --root datasets/BOP_DATASETS --weights yolox_x_ycbv.pth --norm BN [--device cpu]
    python -m gdrnpp_bop2022_torch.tools.test_yolox --config ycbv \
        --root datasets/BOP_DATASETS --ckpt output/yolox/ycbv/ckpt_yolox

``--config`` names a recipe of ``configs.yolox`` (its ``test`` knobs: TTA at
scales 1, .75, .83, 1.12, 1.25 with conf 0.001, NMS 0.65); without it,
``--dataset`` runs the flag defaults (no TTA, conf 0.01). Flags and
``--opts key=value`` override. Weights come from a ``.pth`` state dict in
the reference's names (``--weights``; the released BOP'22 weights are BN),
from the newest checkpoint that ``train_yolox`` wrote under ``--ckpt`` (its
EMA weights with the model's BN statistics, as the JAX CLI serves
``ema_params``), or, with ``--allow-random-weights``, from seed 0. The convolutions run in
bf16 on the card and in fp32 on the CPU. Images are letterboxed
on the host and detected ``--batch-size`` at a time (the last batch padded
with its last image); the first batch runs once untimed first. Writes
``<out>/yolox_<dataset>_<split>_bboxes.json`` (read by ``test_gdrn`` with
``model.load_dets_test=True datasets.det_files_test=(<json>,)``) and prints
the COCO-style mAP against the split's visible GT boxes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..datasets.meta import register_meta_files


def resolve_eval_cfg(args, error=None):
    """The recipe (or the flag defaults) with the flags over it. Returns
    (cfg, conf_thr), conf_thr being the recipe's TTA threshold under TTA,
    unless --conf-thr is given."""
    from .. import configs
    from ..config import YoloxConfig, parse_opts, replace_cfg
    if args.config:
        cfg = configs.yolox(args.config)
    else:
        if args.dataset is None:
            (error or sys.exit)("either --config or --dataset is required")
        cfg = replace_cfg(YoloxConfig(dataset=args.dataset),
                          {"test.tta": False, "test.tta_scales": (0.75, 1.0, 1.25)})
    flag_over = {k: v for k, v in {
        "dataset": args.dataset, "size": args.size,
        "input_size": args.input_size, "norm": args.norm,
        "test.conf_thr": args.conf_thr, "test.nms_thr": args.nms_thr,
        "test.tta": args.tta,
        "test.tta_scales": (tuple(float(s) for s in args.tta_scales.split(","))
                            if args.tta_scales else None),
    }.items() if v is not None}
    if flag_over:
        cfg = replace_cfg(cfg, flag_over)
    if getattr(args, "opts", None):
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    conf_thr = cfg.test.conf_thr_tta if cfg.test.tta else cfg.test.conf_thr
    if args.conf_thr is not None:
        conf_thr = args.conf_thr
    return cfg, conf_thr


def load_yolox_weights(path: str) -> dict:
    """A reference YOLOX checkpoint's state dict: a plain state dict or
    {"model": state dict}, without a DataParallel ``module.`` prefix."""
    payload = torch.load(path, map_location="cpu")
    sd = payload.get("model", payload)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def add_model_args(ap: argparse.ArgumentParser):
    """The detector's weights and device (shared with demo_yolox)."""
    ap.add_argument("--weights", default=None,
                    help="a .pth state dict with the reference's names")
    ap.add_argument("--allow-random-weights", action="store_true",
                    help="run without --weights on weights drawn from seed 0 (smoke "
                         "tests only: an untrained detector emits garbage boxes)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def ckpt_ema_state_dict(ckpt_dir: str) -> dict:
    """The newest ``train_yolox`` checkpoint under ``ckpt_dir`` as a state
    dict to serve: its EMA parameters with the model's buffers (BN running
    statistics; the EMA averages parameters only)."""
    from ..engine.checkpoint import CheckpointManager
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    payload = torch.load(mgr.path(step), map_location="cpu", weights_only=False)
    sd = dict(payload["model"])
    sd.update(payload["ema"])
    return sd


def load_detector(weights, num_classes: int, size: str, norm: str, device):
    """build_yolox on ``device`` with ``weights``: a state dict, the path of
    one, or, for None, weights drawn from seed 0. Its convolutions run in
    bf16 on the card (as the JAX package runs them) and in fp32 on the CPU."""
    from ..models.yolox import build_yolox
    from ..utils.weights import seeded_state_dict
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    model = build_yolox(num_classes, size, norm=norm, device=device, dtype=dtype)
    if isinstance(weights, dict):
        sd = weights
    elif weights:
        sd = load_yolox_weights(weights)
    else:
        print("WARNING: running with RANDOM detector weights", flush=True)
        sd = seeded_state_dict(model, 0)
    model.load_state_dict(sd, strict=True)
    return model


def require_weights(args, error):
    ckpt = getattr(args, "ckpt", None)
    if args.weights and ckpt:
        error("--weights and --ckpt both given: pass one")
    if not args.weights and not ckpt and not args.allow_random_weights:
        error("no --weights given: an untrained detector would emit garbage detections. "
              "Pass --weights, or --allow-random-weights for smoke tests.")


def detect_images(infer, items, input_size: int, batch_size: int, device):
    """items: [(key, HxWx3 uint8 loader)]. Letterboxes, detects a batch at a
    time (the last padded with its last image) after one untimed pass of the
    first batch. Returns ({key: numpy NMS rows + "time"}, {key: ratio},
    stats), "time" being the batch's detection time per image."""
    from ..datasets.yolox_loader import letterbox
    per_image, ratios = {}, {}
    det_s, n_batches = 0.0, 0
    warmed = False
    t_wall = time.perf_counter()
    for b0 in range(0, len(items), batch_size):
        chunk = items[b0:b0 + batch_size]
        canvases = []
        for key, load in chunk:
            canvas, ratios[key] = letterbox(load(), input_size)
            canvases.append(canvas)
        canvases += [canvases[-1]] * (batch_size - len(chunk))
        x = torch.from_numpy(np.stack(canvases)).to(device).float()
        if not warmed:      # cuDNN's algorithm choice and allocations, untimed
            infer(x)["valid"].cpu()
            warmed = True
        t0 = time.perf_counter()
        det = {k: v.cpu().numpy() for k, v in infer(x).items()}
        dt = time.perf_counter() - t0
        det_s += dt
        n_batches += 1
        for bi, (key, _) in enumerate(chunk):
            per_image[key] = {k: v[bi] for k, v in det.items()}
            per_image[key]["time"] = dt / len(chunk)
    wall = time.perf_counter() - t_wall
    stats = {"n_images": len(items), "n_batches": n_batches, "detect_s": det_s,
             "images_per_s": len(items) / det_s if det_s else float("nan"),
             "wall_s": wall, "device": str(device)}
    return per_image, ratios, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="a detector recipe of configs.yolox (e.g. ycbv, tless_real_pbr)")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--root", default="datasets/BOP_DATASETS")
    ap.add_argument("--split", default="test")
    ap.add_argument("--size", default=None)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--norm", default=None, choices=["GN", "BN"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--conf-thr", type=float, default=None)
    ap.add_argument("--nms-thr", type=float, default=None)
    ap.add_argument("--tta", action=argparse.BooleanOptionalAction, default=None,
                    help="multi-scale + horizontal-flip test-time augmentation, one "
                         "joint NMS (reference det/yolox/models/yolox.py:53)")
    ap.add_argument("--tta-scales", default=None, help="comma-separated TTA scales")
    ap.add_argument("--ckpt", default=None,
                    help="a train_yolox checkpoint directory (ckpt_yolox): serve the newest "
                         "checkpoint's EMA weights")
    add_model_args(ap)
    ap.add_argument("--dataset-meta", nargs="+", default=[],
                    help="JSON files of datasets to register first (datasets/meta.py::"
                         "register_meta_file)")
    args = ap.parse_args(argv)
    register_meta_files(args.dataset_meta)

    from ..bop.inout import save_json
    from ..datasets.bop_data import index_bop_split, load_image
    from ..datasets.meta import get_meta
    from ..eval.detection_eval import coco_map, detections_to_bop_json
    from ..models.yolox import make_inference, make_tta_inference

    require_weights(args, ap.error)
    cfg, conf_thr = resolve_eval_cfg(args, error=ap.error)
    meta = get_meta(cfg.dataset)
    weights = ckpt_ema_state_dict(args.ckpt) if args.ckpt else args.weights
    model = load_detector(weights, meta.num_classes, cfg.size, cfg.norm, args.device)
    if cfg.test.tta:
        infer = make_tta_inference(model, scales=tuple(cfg.test.tta_scales), flip=True,
                                   conf_thr=conf_thr, nms_thr=cfg.test.nms_thr)
    else:
        infer = make_inference(model, conf_thr=conf_thr, nms_thr=cfg.test.nms_thr)

    records = index_bop_split(os.path.join(args.root, meta.name, args.split), meta)
    by_img = {}
    for r in records:
        by_img.setdefault(r.scene_im_id, {"path": r.rgb_path, "instances": []})
        by_img[r.scene_im_id]["instances"].append(r)
    keys = sorted(by_img)
    items = [(k, lambda p=by_img[k]["path"]: load_image(p)) for k in keys]
    per_image, ratios, stats = detect_images(infer, items, cfg.input_size,
                                             max(1, args.batch_size), args.device)

    out_dir = args.out or f"output/yolox/{meta.name}"
    os.makedirs(out_dir, exist_ok=True)
    handoff = detections_to_bop_json(per_image, meta.label_to_obj_id(), scale_factors=ratios)
    out_json = os.path.join(out_dir, f"yolox_{meta.name}_{args.split}_bboxes.json")
    save_json(out_json, handoff)
    gts, dets_eval = {}, {}
    for key in keys:
        gts[key] = [{"bbox_xyxy": rec.bbox_visib, "label": rec.label}
                    for rec in by_img[key]["instances"] if rec.bbox_visib is not None]
        v = per_image[key]
        dets_eval[key] = [{"bbox_xyxy": v["boxes_xyxy"][i] / ratios[key],
                           "label": int(v["labels"][i]), "score": float(v["scores"][i])}
                          for i in np.nonzero(v["valid"] & (v["scores"] > 0))[0]]
    m = coco_map(dets_eval, gts, meta.num_classes)
    print(f"wrote handoff json: {out_json} ({len(handoff)} images)")
    print(f"detected {stats['n_images']} images in {stats['n_batches']} batches of "
          f"{args.batch_size} ({'TTA' if cfg.test.tta else 'plain'}, {stats['device']}): {stats['images_per_s']:.1f} images/s in detection, "
          f"{stats['wall_s']:.2f} s with loading and letterbox")
    print(f"mAP {m['mAP']:.4f}  AP50 {m['AP50']:.4f}")
    return handoff, m, stats


if __name__ == "__main__":
    main()
