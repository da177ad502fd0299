"""Visualise dataset ground truth: GT pose 3D boxes, visible-mask overlays
and DZI-jittered crops.

The port's copy of ``tools/vis_dataset.py`` (reference per-dataset
``test_vis()`` blocks and core/gdrn_modeling/tools/lm/5_vis_DZI.py), over the
port's ``datasets/bop_data.py``, ``datasets/meta.py``, ``bop/models3d.py``,
``engine/batching.dzi_jitter_host`` and ``utils/vis.py``; host code:

    python -m gdrnpp_bop2022_torch.tools.vis_dataset --config ycbv_convnext_base \
        --dataset ycbv_test --num-images 4 --dzi --out /tmp/vis
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..bop.models3d import load_models_info
from ..datasets.bop_data import index_bop_split, load_image, load_mask
from ..datasets.meta import get_meta
from ..engine.batching import dzi_jitter_host
from ..utils.vis import draw_pose_bbox, grid_show, overlay_mask


def _extent_from_info(info: dict) -> np.ndarray:
    return np.array([info["size_x"], info["size_y"], info["size_z"]],
                    np.float32) / 1000.0


def vis_records(records, models_info, n_images: int, out_dir: str,
                dzi_cfg=None, seed: int = 0) -> list:
    """Render per-image GT panels; returns written paths."""
    by_image = {}
    for r in records:
        by_image.setdefault(r.scene_im_id, []).append(r)

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    outputs = []
    for sid, insts in sorted(by_image.items())[:n_images]:
        img = load_image(insts[0].rgb_path).copy()
        K = insts[0].K
        panel_pose = img.copy()
        panel_mask = img.copy()
        for j, inst in enumerate(insts):
            if inst.pose is not None and inst.obj_id in models_info:
                ext = _extent_from_info(models_info[inst.obj_id])
                panel_pose = draw_pose_bbox(panel_pose, K, inst.pose[:, :3],
                                            inst.pose[:, 3], ext)
            if inst.mask_visib_path and os.path.exists(inst.mask_visib_path):
                m = load_mask(inst.mask_visib_path)
                color = [(255, 0, 0), (0, 255, 0), (0, 0, 255),
                         (255, 255, 0)][j % 4]
                panel_mask = overlay_mask(panel_mask, m > 0, color=color)
        panels = [img, panel_pose, panel_mask]
        titles = ["rgb", "gt_pose_boxes", "gt_masks"]

        box_list = [inst.bbox_visib for inst in insts
                    if inst.bbox_visib is not None]
        if dzi_cfg is not None and box_list:
            boxes = np.stack(box_list)
            centers, scales = dzi_jitter_host(
                rng, boxes.astype(np.float32), img.shape[1], img.shape[0],
                pad_scale=dzi_cfg.dzi_pad_scale,
                scale_ratio=dzi_cfg.dzi_scale_ratio,
                shift_ratio=dzi_cfg.dzi_shift_ratio,
                dzi_type=dzi_cfg.dzi_type)
            panel_dzi = img.copy()
            try:
                import cv2
                for b in boxes.astype(int):
                    cv2.rectangle(panel_dzi, (b[0], b[1]), (b[2], b[3]),
                                  (0, 255, 0), 2)
                for c, s in zip(centers, scales):
                    x0, y0 = int(c[0] - s / 2), int(c[1] - s / 2)
                    cv2.rectangle(panel_dzi, (x0, y0),
                                  (int(x0 + s), int(y0 + s)), (255, 0, 0), 2)
            except ImportError:
                pass
            panels.append(panel_dzi)
            titles.append("dzi(green=gt, blue=jittered)")

        out_path = os.path.join(out_dir, f"{sid.replace('/', '_')}.png")
        grid_show(panels, titles=titles, out_path=out_path, cols=len(panels))
        outputs.append(out_path)
    return outputs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default', a GDRN recipe of configs.py or <dataset>SO/<obj>")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    ap.add_argument("--dataset", default=None,
                    help="dataset name like ycbv_test; default cfg.datasets.test[0]")
    ap.add_argument("--num-images", type=int, default=4)
    ap.add_argument("--dzi", action="store_true",
                    help="also draw DZI-jittered boxes")
    ap.add_argument("--out", default="output/vis_dataset")
    args = ap.parse_args(argv)

    from ..config import parse_opts, replace_cfg
    from .test_gdrn import load_config
    cfg = load_config(args.config)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    name = args.dataset or cfg.datasets.test[0]
    meta = get_meta(name)
    split = name.split("_", 1)[1] if "_" in name else "test"
    split_dir = os.path.join(cfg.datasets.root, meta.name, split)
    records = index_bop_split(split_dir, meta)
    models_info = load_models_info(meta.models_dir(cfg.datasets.root))
    outs = vis_records(records, models_info, args.num_images, args.out,
                       dzi_cfg=cfg.input if args.dzi else None)
    print(f"wrote {len(outs)} visualization grids to {args.out}")
    return outs


if __name__ == "__main__":
    main()
