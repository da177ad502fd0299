"""Detector demo on one card: a folder of images -> boxes drawn, and
optionally the detections as json.

The port's counterpart of ``tools/demo_yolox.py`` (reference
det/yolox/tools/demo.py, image / folder / webcam modes):

    python -m gdrnpp_bop2022_torch.tools.demo_yolox --dataset ycbv \\
        --weights yolox_x_ycbv.pth --norm BN --images demo_imgs/ \\
        --out output/demo_yolox [--save-dets dets.json] [--max-frames N] \\
        [--register my_dataset.py] [--device cpu]

``--images`` is a folder, a glob, or a camera index (digits: frames from
``cv2.VideoCapture``, BGR -> RGB, named cam_%06d). ``--max-frames`` stops
after that many frames (0: all). ``--register FILE`` runs a python file
first, e.g. one that calls ``datasets.meta.register_meta`` for a custom
dataset. Plain inference (no TTA) at ``--input-size``, boxes above
``--conf-thr``. ``--save-dets`` writes {image name: [{obj_id, bbox_est
xywh, score}]}, which ``demo_gdrn --dets`` reads.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def image_paths(source: str):
    """A folder's .png / .jpg files, or a glob's, sorted."""
    pattern = source if any(c in source for c in "*?[") else os.path.join(source, "*")
    return [p for p in sorted(glob.glob(pattern))
            if os.path.splitext(p)[1].lower() in (".png", ".jpg", ".jpeg")]


def iter_frames(source: str):
    """(name, RGB image) from a camera index (digits) or a folder / glob."""
    if source.isdigit():
        import cv2
        cap = cv2.VideoCapture(int(source))
        try:
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield f"cam_{i:06d}", np.ascontiguousarray(frame[..., ::-1])
                i += 1
        finally:
            cap.release()
    else:
        from ..datasets.bop_data import load_image
        for p in image_paths(source):
            yield os.path.splitext(os.path.basename(p))[0], load_image(p)


def run_file(path: str) -> None:
    """Run a python file as a module (``--register``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("demo_register", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--images", required=True, help="a folder, a glob or a camera index")
    ap.add_argument("--size", default="yolox_x")
    ap.add_argument("--input-size", type=int, default=640)
    ap.add_argument("--norm", default="GN", choices=["GN", "BN"])
    ap.add_argument("--conf-thr", type=float, default=0.3)
    ap.add_argument("--nms-thr", type=float, default=0.65)
    ap.add_argument("--out", default="output/demo_yolox")
    ap.add_argument("--save-dets", default=None)
    ap.add_argument("--max-frames", type=int, default=0, help="stop after N frames (0: all)")
    ap.add_argument("--register", default=None,
                    help="a python file run first (e.g. to register a custom dataset)")
    from .test_yolox import add_model_args, load_detector, require_weights
    add_model_args(ap)
    args = ap.parse_args(argv)

    import cv2

    from ..datasets.meta import get_meta
    from ..utils.vis import draw_detections
    from .demo_gdrn import build_detector

    require_weights(args, ap.error)
    if args.register:
        run_file(args.register)
    meta = get_meta(args.dataset)
    model = load_detector(args.weights, meta.num_classes, args.size, args.norm, args.device)
    detect = build_detector(model, args.input_size, args.conf_thr, args.nms_thr)
    label2obj = meta.label_to_obj_id()
    os.makedirs(args.out, exist_ok=True)
    all_dets = {}
    for name, img in iter_frames(args.images):
        boxes, labels, scores = detect(img)
        obj_ids = [label2obj[int(lab)] for lab in labels]
        vis = draw_detections(img, boxes, [meta.id2obj[o] for o in obj_ids], scores)
        cv2.imwrite(os.path.join(args.out, f"{name}_det.png"), vis[..., ::-1])
        all_dets[name] = [{"obj_id": o, "bbox_est": [float(b[0]), float(b[1]),
                                                     float(b[2] - b[0]), float(b[3] - b[1])],
                           "score": float(s)} for o, b, s in zip(obj_ids, boxes, scores)]
        if args.max_frames and len(all_dets) >= args.max_frames:
            break
    if args.save_dets:
        with open(args.save_dets, "w") as f:
            json.dump(all_dets, f)
    print(f"detected on {len(all_dets)} frames -> {args.out}")
    return all_dets


if __name__ == "__main__":
    main()
