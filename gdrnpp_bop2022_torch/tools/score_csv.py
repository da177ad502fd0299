"""Score a saved BOP result CSV without running the network.

The port's counterpart of ``tools/score_csv.py`` (reference VAL.EVAL_CACHED /
EVAL_PRINT_ONLY, test_utils.py:83-140): the in-process scorer on the card,
unless ``--device cpu`` is given.

    python -m gdrnpp_bop2022_torch.tools.score_csv --csv poses.csv \
        --dataset ycbv --root datasets/BOP_DATASETS [--split test] [--device cpu]

Prints the scores as JSON.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--root", default="datasets/BOP_DATASETS")
    ap.add_argument("--split", default="test")
    ap.add_argument("--no-vsd", action="store_true")
    ap.add_argument("--vsd-mode", default="full", choices=["auto", "window", "full"],
                    help="full = strict BOP-toolkit-equivalent rendering")
    # the per-dataset evaluation grid (eval_pose_results_more.py:41-83)
    # comes from the dataset meta; the flags override it
    ap.add_argument("--vsd-delta", type=float, default=None,
                    help="VSD tolerance in meters (default: the dataset's)")
    ap.add_argument("--n-top", type=int, default=None,
                    help="top-N estimates per target (-1 = all)")
    ap.add_argument("--visib-gt-min", type=float, default=None,
                    help="min GT visible fraction (default: the dataset's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from ..bop.inout import load_bop_results, load_test_targets
    from ..bop.models3d import ModelBank
    from ..datasets.bop_data import index_bop_split, load_depth
    from ..datasets.meta import get_meta
    from ..eval.scorer import score_bop_results

    meta = get_meta(args.dataset)
    models_eval = meta.models_dir(args.root, "models_eval")
    bank = ModelBank.from_bop_models_dir(
        models_eval if os.path.isdir(models_eval) else meta.models_dir(args.root))

    results = load_bop_results(args.csv)
    for r in results:
        r["t"] = np.asarray(r["t"]) / 1000.0   # mm -> m
        r["K"] = meta.camera_matrix.astype(np.float32)

    records = index_bop_split(os.path.join(args.root, meta.name, args.split), meta)
    gt_rows = [{"scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
                "R": r.pose[:, :3], "t": r.pose[:, 3], "visib_fract": r.visib_fract}
               for r in records if r.pose is not None]
    targets_path = os.path.join(args.root, meta.name, "test_targets_bop19.json")
    targets = load_test_targets(targets_path) if os.path.exists(targets_path) else None

    depth_getter = None
    if not args.no_vsd:
        by_key = {(r.scene_id, r.im_id): r for r in records}

        def depth_getter(scene_id, im_id):
            rec = by_key.get((scene_id, im_id))
            if rec is None or rec.depth_path is None:
                return None
            return load_depth(rec.depth_path, rec.depth_scale, meta.depth_factor)

    scores = score_bop_results(
        results, gt_rows, bank, targets=targets, im_width=meta.width,
        depth_test_getter=depth_getter, vsd_mode=args.vsd_mode,
        vsd_delta=meta.vsd_delta if args.vsd_delta is None else args.vsd_delta,
        n_top=meta.eval_n_top if args.n_top is None else args.n_top,
        visib_gt_min=meta.visib_gt_min if args.visib_gt_min is None else args.visib_gt_min,
        device=args.device)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()
