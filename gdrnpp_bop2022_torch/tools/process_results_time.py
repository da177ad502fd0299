"""Normalise per-image times across BOP result CSVs and merge them.

The port's copy of ``tools/process_results_time.py`` (reference
tools/process_bop_results_time.py): every row of an image gets the largest
time among that image's rows in all the input files.

    python -m gdrnpp_bop2022_torch.tools.process_results_time merged.csv in1.csv in2.csv ...
"""

from __future__ import annotations

import sys
from collections import defaultdict


def process(out_path: str, paths) -> int:
    """Write the rows of ``paths`` with per-image times to ``out_path``;
    returns the row count."""
    from ..bop.inout import load_bop_results, save_bop_results
    rows = []
    for p in paths:
        rows.extend(load_bop_results(p))
    by_image = defaultdict(list)
    for r in rows:
        by_image[(r["scene_id"], r["im_id"])].append(r)
    for group in by_image.values():
        t = max(r["time"] for r in group)
        for r in group:
            r["time"] = t
    save_bop_results(out_path, rows)
    return len(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        sys.exit(1)
    n = process(argv[0], argv[1:])
    print(f"wrote {n} rows -> {argv[0]}")
    return n


if __name__ == "__main__":
    main()
