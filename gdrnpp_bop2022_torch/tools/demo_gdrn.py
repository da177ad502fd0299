"""End-to-end demo on one card: images -> YOLOX detections -> GDRN poses ->
projected 3D boxes.

The port's counterpart of ``tools/demo_gdrn.py`` (reference
core/gdrn_modeling/demo/demo_gdrn.py, folder and webcam modes):

    python -m gdrnpp_bop2022_torch.tools.demo_gdrn --config ycbv_convnext_base \\
        (--images 'demo/*.png' | --camera 0 [--max-frames N]) --weights gdrn.pth \\
        (--yolox-weights yolox.pth [--yolox-norm BN] | --dets test_bboxes.json) \\
        [--cam-K fx 0 cx 0 fy cy 0 0 1] [--depth-images 'demo/*_depth.png' \\
        --depth-refine] --out demo_out [--device cpu]

Frames come from image files (``--images``, sorted) or from a camera
(``--camera`` index through ``cv2.VideoCapture``, BGR -> RGB, at most
``--max-frames``, named ``camera_%06d.png``). Detections come from the
detector inline (``--yolox-weights``, or ``--yolox-random-weights``; plain
inference, no TTA, boxes above ``--conf-thr``) or from a handoff json
(``--dets``, keyed by image name or ``0/<im_id>``). The poses come from
``engine.inference.run_gdrn_inference`` over ``datasets.test_loader``
batches of 64 ROIs, with ``--cam-K`` or the dataset's camera:
``post_mode="direct"``, or with ``--depth-refine`` ``"depth_refine"``: the
sensor depth (``--depth-images``, sorted and paired with the sorted images,
raw values / ``--depth-scale`` in meters) cropped nearest-neighbour and
the translation refined by ``eval/pnp_eval.py::depth_refine_batch``
(``--depth-refine-iters``, ``--depth-refine-threshold``) through kernel B2,
as the JAX demo refines an RGB model's poses. Depth refinement needs file
input; RGB-D models are refused (the demo serves RGB models). GDRN's
weights: ``--weights`` (a .pth state dict or training checkpoint) or
``--seed``. Writes ``<out>/<image name>`` with each object's 3D box.
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


def camera_frames(index: int, max_frames: int):
    """(name, RGB frame) from ``cv2.VideoCapture(index)``, at most
    ``max_frames``, named camera_%06d.png."""
    import cv2
    cap = cv2.VideoCapture(index)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera {index}")
    try:
        for i in range(max_frames):
            ok, frame = cap.read()
            if not ok:
                break
            yield f"camera_{i:06d}.png", np.ascontiguousarray(frame[..., ::-1])
    finally:
        cap.release()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default' (Config()) or a GDRN config of configs.py")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", nargs="+", help="image files or globs")
    src.add_argument("--camera", type=int, help="a camera index (cv2.VideoCapture)")
    ap.add_argument("--max-frames", type=int, default=300, help="frames read from --camera")
    ap.add_argument("--cam-K", nargs=9, type=float, default=None,
                    help="the camera matrix, row-major (default: the dataset's)")
    ap.add_argument("--depth-images", nargs="+", default=None,
                    help="depth files or globs, sorted and paired with the sorted --images")
    ap.add_argument("--depth-scale", type=float, default=1000.0,
                    help="raw depth / this = meters (BOP uint16 mm PNGs: 1000)")
    ap.add_argument("--depth-refine", action="store_true",
                    help="refine the translations against the sensor depth")
    ap.add_argument("--depth-refine-iters", type=int, default=2)
    ap.add_argument("--depth-refine-threshold", type=float, default=0.8)
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
    if args.depth_refine and not args.depth_images:
        ap.error("--depth-refine needs --depth-images")
    if args.depth_refine and args.camera is not None:
        ap.error("--depth-refine needs file input (--images)")

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
    K = (np.asarray(args.cam_K, np.float32).reshape(3, 3) if args.cam_K
         else meta.camera_matrix.astype(np.float32))
    if args.camera is not None:
        frames = list(camera_frames(args.camera, args.max_frames))
    else:
        paths = sorted(sum((glob.glob(p) for p in args.images), []))
        if not paths:
            raise SystemExit("no images matched --images")
        frames = [(os.path.basename(p), p) for p in paths]
    depth_paths = None
    if args.depth_refine:
        depth_paths = sorted(sum((glob.glob(p) for p in args.depth_images), []))
        if len(depth_paths) < len(frames):
            raise SystemExit(f"{len(depth_paths)} depth images for {len(frames)} images")
    image = lambda src: load_image(src) if isinstance(src, str) else src   # noqa: E731

    if args.dets:
        dets_map, detect = load_json(args.dets), None
    else:
        detector = load_detector(args.yolox_weights, meta.num_classes, args.yolox_size,
                                 args.yolox_norm, args.device)
        detect = build_detector(detector, args.yolox_input_size, args.conf_thr, args.nms_thr)

    obj2label, label2obj = meta.obj_id_to_label(), meta.label_to_obj_id()
    index, dets, names = {}, {}, {}
    for i, (name, src) in enumerate(frames):
        key = f"0/{i}"
        names[i] = name
        index[key] = ({"rgb_path": src} if isinstance(src, str) else {"image": src})
        index[key].update(K=K, scene_id=0, im_id=i)
        if depth_paths:
            # load_depth gives raw * depth_scale / 1000 m: raw / --depth-scale
            index[key].update(depth_path=depth_paths[i], depth_scale=1000.0 / args.depth_scale)
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
            boxes, labels, scores = detect(image(src))
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
        model, iter_test_batches(index, dets, batch_size=64, with_depth=args.depth_refine),
        bank.extents, input_res=pc.input_res, output_res=pc.output_res,
        pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
        post_mode="depth_refine" if args.depth_refine else "direct", model_bank=bank,
        depth_refine_iters=args.depth_refine_iters,
        depth_refine_threshold=args.depth_refine_threshold,
        mask_loss_type=pc.loss.mask_loss_type, coord_2d_type=pc.pnp_net.coord_2d_type)

    os.makedirs(args.out, exist_ok=True)
    by_im = {}
    for r in results:
        by_im.setdefault(r["im_id"], []).append(r)
    written = []
    for i, rows in sorted(by_im.items()):
        vis = image(frames[i][1])
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
