#!/usr/bin/env python3
"""Readings of the comparison that decides ``correct``, over many seeds.

    python3 bench_h100/calibrate.py --workload <cell> --seeds 11 12 ... [--seconds 3]
        [--opts '{"model.pose_net.backbone.int8_mlp": true}'] [--fault name[:size]]
        [--out file.jsonl] [--rows file.npz]

Each seed runs as a benchmark run does (its weights, pool, warm-up, a short
window at the cell's load, the reference over every row), without the
metrics. ``--opts`` switches on a path of the program, such as its int8
MLPs, the control in the precision below the configuration's bf16;
``--fault`` plants one of ``faults.py``'s faults under the served path. The
limits in ``configs/<config>.json`` were set from these readings
(``PERF.md`` gives them). One JSON line a seed; ``--rows`` keeps every row's
gaps, a key per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--opts", default="{}")
    ap.add_argument("--fault")
    ap.add_argument("--out")
    ap.add_argument("--rows")
    args = ap.parse_args(argv)
    import torch
    from bench_h100 import compare, faults
    from bench_h100.harness import Session, load_cell
    if not torch.cuda.is_available():
        print("calibrate.py reads the card's serving; this machine has none", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    opts = json.loads(args.opts)
    planted = faults.plant(args.fault) if args.fault else None
    kept = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = Session(cell, "cuda", opts).serve(seed, args.seconds, trace=False)
        line = json.dumps({"workload": args.workload, "opts": opts, "fault": args.fault,
                           "seed": seed, "correct": out["correct"],
                           "readings": out["_readings"], "window": out["_window"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        for g in compare.GAPS:
            kept[f"{seed}.{g}"] = out["_rows"][g].astype(np.float32)
    if planted:
        planted.remove()
    if args.rows:
        np.savez_compressed(args.rows, **kept)
    return 0


if __name__ == "__main__":
    sys.exit(main())
