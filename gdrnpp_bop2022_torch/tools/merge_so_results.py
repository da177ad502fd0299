"""Merge per-object ("SO") BOP result CSVs into one submission file.

The port's copy of ``tools/merge_so_results.py`` (reference
tools/merge_bop_single_obj_results.py): the per-object workflow writes one
poses.csv per object config (``configs.so``, ``--config <ds>SO/<obj>``);
BOP scoring wants one CSV. Each image's time column is set to the largest
time among the merged rows of that image (BOP: every estimate of an image
reports one time) unless ``--no-time-normalize``.

    python -m gdrnpp_bop2022_torch.tools.merge_so_results out/*/inference/*/poses.csv \
        --out merged/gdrn_ycbv-test.csv
"""

from __future__ import annotations

import argparse
import os


def merge_csvs(paths, out_path, normalize_time=True):
    from collections import defaultdict
    header = None
    rows = []
    for p in paths:
        with open(p) as f:
            lines = [l.rstrip("\r\n") for l in f if l.strip()]
        if not lines:
            continue
        if header is None:
            header = lines[0]
        elif lines[0] != header:
            raise ValueError(f"{p}: header mismatch: {lines[0]!r} vs {header!r}")
        rows.extend(lines[1:])
    if header is None:
        raise ValueError("no input rows")

    if normalize_time:
        cols = header.split(",")
        i_scene, i_im = cols.index("scene_id"), cols.index("im_id")
        i_time = cols.index("time")
        parsed = [r.split(",") for r in rows]
        t_max = defaultdict(float)
        for r in parsed:
            key = (r[i_scene], r[i_im])
            t_max[key] = max(t_max[key], float(r[i_time]))
        for r in parsed:
            r[i_time] = f"{t_max[(r[i_scene], r[i_im])]:.6f}"
        rows = [",".join(r) for r in parsed]

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(r + "\n")
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-time-normalize", action="store_true")
    args = ap.parse_args(argv)
    n = merge_csvs(args.paths, args.out,
                   normalize_time=not args.no_time_normalize)
    print(f"merged {len(args.paths)} files, {n} rows -> {args.out}")
    return n


if __name__ == "__main__":
    main()
