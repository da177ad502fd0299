"""End-to-end demo on one card: images -> YOLOX detections -> GDRN poses ->
projected 3D boxes.

The port's counterpart of ``tools/demo_gdrn.py`` (reference
core/gdrn_modeling/demo/demo_gdrn.py, folder mode):

    python -m gdrnpp_bop2022_torch.tools.demo_gdrn --config ycbv_convnext_base \\
        --images 'demo/*.png' --weights gdrn.pth \\
        (--yolox-weights yolox.pth [--yolox-norm BN] | --dets test_bboxes.json) \\
        --out demo_out [--device cpu]

Detections come from the detector inline (``--yolox-weights``, or
``--yolox-random-weights``; plain inference, no TTA, boxes above
``--conf-thr``) or from a handoff json (``--dets``, keyed by image name or
``0/<im_id>``). The poses come from ``engine.inference.run_gdrn_inference``
(``post_mode="direct"``, the dataset's camera) over ``datasets.test_loader``
batches of 64 ROIs. GDRN's weights: ``--weights`` (a .pth state dict or
training checkpoint) or ``--seed``. Writes ``<out>/<image name>`` with each
object's 3D box. Camera input and depth refinement are not ported.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch


def build_detector(model, input_size: int, conf_thr: float, nms_thr: float):
    """Inline stage 1 (reference demo/predictor_yolo.py): detect(img HxWx3
    uint8) -> (boxes xyxy in the image, labels, scores) above conf_thr."""
    from ..datasets.yolox_loader import letterbox
    from ..models.yolox import make_inference
    infer = make_inference(model, conf_thr=conf_thr, nms_thr=nms_thr)
    device = next(model.parameters()).device

    def detect(img):
        canvas, r = letterbox(img, input_size)
        det = {k: v[0].cpu().numpy()
               for k, v in infer(torch.from_numpy(canvas)[None].to(device).float()).items()}
        keep = det["valid"] & (det["scores"] > conf_thr)
        return det["boxes_xyxy"][keep] / r, det["labels"][keep].astype(int), det["scores"][keep]

    return detect


def _dets_for(dets_map, name):
    """The handoff json's rows for an image file name, keyed by its stem or
    by ``0/<int stem>``."""
    key = os.path.splitext(name)[0]
    for k in (key, f"0/{int(key)}" if key.isdigit() else key):
        if k in dets_map:
            return dets_map[k]
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default' (Config()) or a GDRN config of configs.py")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--images", nargs="+", required=True, help="image files or globs")
    w = ap.add_mutually_exclusive_group(required=True)
    w.add_argument("--weights", help="GDRN: a .pth state dict with the reference's names")
    w.add_argument("--seed", type=int, help="GDRN: random weights drawn from this seed")
    d = ap.add_mutually_exclusive_group(required=True)
    d.add_argument("--dets", help="a detections json (the handoff format)")
    d.add_argument("--yolox-weights", help="run the detector inline with these weights")
    d.add_argument("--yolox-random-weights", action="store_true",
                   help="run the detector inline on weights drawn from seed 0 (smoke "
                        "tests only)")
    ap.add_argument("--yolox-size", default="yolox_x")
    ap.add_argument("--yolox-input-size", type=int, default=640)
    ap.add_argument("--yolox-norm", default="GN", choices=["GN", "BN"])
    ap.add_argument("--conf-thr", type=float, default=0.3)
    ap.add_argument("--nms-thr", type=float, default=0.65)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import cv2

    from ..bop.inout import load_json
    from ..bop.models3d import ModelBank
    from ..config import parse_opts, replace_cfg
    from ..datasets.bop_data import load_image
    from ..datasets.meta import get_meta
    from ..datasets.test_loader import iter_test_batches
    from ..engine.inference import run_gdrn_inference
    from ..models.gdrn import build_gdrn
    from ..utils.vis import draw_pose_bbox
    from ..utils.weights import seeded_state_dict
    from .test_gdrn import load_config, weights_to_serve
    from .test_yolox import load_detector

    cfg = load_config(args.config)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    if cfg.input.with_depth:
        raise SystemExit(f"--config {args.config}: the demo serves RGB models")
    meta = get_meta(cfg.val.dataset_name)
    bank = ModelBank.from_bop_models_dir(meta.models_dir(cfg.datasets.root),
                                         num_fps=cfg.model.pose_net.geo_head.num_regions)
    K = meta.camera_matrix.astype(np.float32)
    paths = sorted(sum((glob.glob(p) for p in args.images), []))
    if not paths:
        raise SystemExit("no images matched --images")

    if args.dets:
        dets_map, detect = load_json(args.dets), None
    else:
        detector = load_detector(args.yolox_weights, meta.num_classes, args.yolox_size,
                                 args.yolox_norm, args.device)
        detect = build_detector(detector, args.yolox_input_size, args.conf_thr, args.nms_thr)

    obj2label, label2obj = meta.obj_id_to_label(), meta.label_to_obj_id()
    index, dets, names = {}, {}, {}
    for i, p in enumerate(paths):
        name = os.path.basename(p)
        key = f"0/{i}"
        names[i] = name
        index[key] = {"rgb_path": p, "K": K, "scene_id": 0, "im_id": i}
        if detect is None:
            rows = _dets_for(dets_map, name)
            if rows is None:
                print(f"{name}: no detections in {args.dets}, skipping")
                continue
            dets[key] = [{"obj_id": r["obj_id"], "label": obj2label[r["obj_id"]],
                          "bbox_xyxy": np.array([r["bbox_est"][0], r["bbox_est"][1],
                                                 r["bbox_est"][0] + r["bbox_est"][2],
                                                 r["bbox_est"][1] + r["bbox_est"][3]],
                                                np.float32),
                          "score": float(r.get("score", 1.0)), "time": 0.0}
                         for r in rows if r["obj_id"] in obj2label]
        else:
            t0 = time.perf_counter()
            boxes, labels, scores = detect(load_image(p))
            dt = time.perf_counter() - t0
            dets[key] = [{"obj_id": label2obj[int(lab)], "label": int(lab),
                          "bbox_xyxy": np.asarray(b, np.float32), "score": float(s),
                          "time": dt} for b, lab, s in zip(boxes, labels, scores)]
        if not dets[key]:
            print(f"{name}: nothing detected")
            del dets[key]

    model = build_gdrn(cfg, device=args.device)
    if args.weights:
        sd = weights_to_serve(torch.load(args.weights, map_location="cpu"),
                              cfg.model.ema_enabled)
    else:
        sd = seeded_state_dict(model, args.seed)
    model.load_state_dict(sd, strict=True)
    pc = cfg.model.pose_net
    results = run_gdrn_inference(
        model, iter_test_batches(index, dets, batch_size=64), bank.extents,
        input_res=pc.input_res, output_res=pc.output_res, pixel_mean=cfg.model.pixel_mean,
        pixel_std=cfg.model.pixel_std, mask_loss_type=pc.loss.mask_loss_type,
        coord_2d_type=pc.pnp_net.coord_2d_type)

    os.makedirs(args.out, exist_ok=True)
    by_im = {}
    for r in results:
        by_im.setdefault(r["im_id"], []).append(r)
    written = []
    for i, rows in sorted(by_im.items()):
        vis = load_image(paths[i])
        for r in rows:
            lab = obj2label[r["obj_id"]]
            vis = draw_pose_bbox(vis, K, r["R"], r["t"], bank.extents[lab],
                                 center=bank.centers[lab])
        out_path = os.path.join(args.out, names[i])
        cv2.imwrite(out_path, np.ascontiguousarray(vis[..., ::-1]))
        written.append(out_path)
        print(f"{names[i]} -> {out_path} ({len(rows)} objects)")
    return results, written


if __name__ == "__main__":
    main()
