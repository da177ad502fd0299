"""Detection-format conversion: external detector outputs <-> the
``test_bboxes`` json that feeds GDRN (the stage-1 -> stage-2 handoff).

The port's copy of ``tools/convert_dets.py`` (host json / csv work, no
device code), over the port's ``bop/inout.py``:

    python -m gdrnpp_bop2022_torch.tools.convert_dets coco2ours in.json out.json [--score-thr T]
    python -m gdrnpp_bop2022_torch.tools.convert_dets ours2coco in.json out.json
    python -m gdrnpp_bop2022_torch.tools.convert_dets combine dets.json poses.csv out.json

  coco2ours    BOP-COCO detection list json
               [{scene_id, image_id, category_id, bbox(xywh), score, time}]
               -> {"<scene>/<im>": [{obj_id, bbox_est(xywh), score, time}]}
  ours2coco    the reverse
  combine      detections json + pose CSV -> per-image rows carrying both
               bbox_est and pose_est (reference tools/tless/combine_det_pose.py)
"""

from __future__ import annotations

import argparse
import json


def coco_to_ours(dets: list, score_thr: float = 0.0) -> dict:
    """[{scene_id, image_id, category_id, bbox, score, time?}] ->
    {scene_im_id: [{obj_id, bbox_est, score, time}]} (reference
    convert_det_to_our_format.py loop)."""
    out: dict = {}
    for d in dets:
        if float(d.get("score", 1.0)) < score_thr:
            continue
        key = f"{int(d['scene_id'])}/{int(d['image_id'])}"
        out.setdefault(key, []).append({
            "obj_id": int(d["category_id"]),
            "bbox_est": [float(v) for v in d["bbox"]],
            "score": float(d.get("score", 1.0)),
            "time": float(d.get("time", 0.0)),
        })
    return out


def ours_to_coco(dets: dict) -> list:
    out = []
    for key, lst in dets.items():
        scene_id, im_id = (int(v) for v in key.split("/"))
        for d in lst:
            out.append({
                "scene_id": scene_id, "image_id": im_id,
                "category_id": int(d["obj_id"]),
                "bbox": [float(v) for v in d["bbox_est"]],
                "score": float(d.get("score", 1.0)),
                "time": float(d.get("time", 0.0)),
            })
    return out


def combine_det_pose(dets: dict, csv_rows: list) -> dict:
    """Attach estimated poses (BOP CSV rows: R row-major, t in mm) to their
    detections by (scene, im, obj) in score order (reference
    combine_det_pose.py): -> {scene_im_id: [{obj_id, score, bbox_est,
    pose_est(3x4, t in m), time}]}."""
    from collections import defaultdict

    by_key = defaultdict(list)
    for r in csv_rows:
        by_key[(int(r["scene_id"]), int(r["im_id"]), int(r["obj_id"]))].append(r)
    for lst in by_key.values():
        lst.sort(key=lambda r: -float(r["score"]))

    out: dict = {}
    for key, lst in dets.items():
        scene_id, im_id = (int(v) for v in key.split("/"))
        rows = []
        used = defaultdict(int)
        for d in sorted(lst, key=lambda d: -float(d.get("score", 1.0))):
            k = (scene_id, im_id, int(d["obj_id"]))
            cand = by_key.get(k, [])
            i = used[k]
            row = dict(obj_id=int(d["obj_id"]),
                       score=float(d.get("score", 1.0)),
                       bbox_est=[float(v) for v in d["bbox_est"]],
                       time=float(d.get("time", 0.0)))
            if i < len(cand):
                r = cand[i]
                used[k] += 1
                R = [[float(v) for v in r["R"][j]] for j in range(3)]
                t = [float(v) / 1000.0 for v in r["t"]]
                row["pose_est"] = [R[j] + [t[j]] for j in range(3)]
            rows.append(row)
        if rows:
            out[key] = rows
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("coco2ours")
    p1.add_argument("input")
    p1.add_argument("output")
    p1.add_argument("--score-thr", type=float, default=0.0)
    p2 = sub.add_parser("ours2coco")
    p2.add_argument("input")
    p2.add_argument("output")
    p3 = sub.add_parser("combine")
    p3.add_argument("dets", help="test_bboxes json")
    p3.add_argument("csv", help="BOP result CSV with pose rows")
    p3.add_argument("output")
    args = ap.parse_args(argv)

    if args.cmd == "coco2ours":
        with open(args.input) as f:
            dets = json.load(f)
        out = coco_to_ours(dets, args.score_thr)
    elif args.cmd == "ours2coco":
        with open(args.input) as f:
            dets = json.load(f)
        out = ours_to_coco(dets)
    else:
        from ..bop.inout import load_bop_results
        with open(args.dets) as f:
            dets = json.load(f)
        out = combine_det_pose(dets, load_bop_results(args.csv))
    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    n = len(out)
    print(f"wrote {args.output}: {n} {'images' if isinstance(out, dict) else 'rows'}")


if __name__ == "__main__":
    main()
