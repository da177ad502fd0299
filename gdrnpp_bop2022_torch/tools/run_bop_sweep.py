"""The BOP sweep over datasets: detector -> handoff json -> GDRN -> scores.

The port's counterpart of ``tools/run_bop_sweep.py`` (reference README's
per-dataset train_yolox / test_yolox / train_gdrn / test_gdrn workflow),
each stage a subprocess of its own, one dataset after the other:

    python -m gdrnpp_bop2022_torch.tools.run_bop_sweep --datasets ycbv lmo \\
        --root datasets/BOP_DATASETS --mode eval --yolox-ckpt 'output/yolox/{ds}/ckpt_yolox' \\
        --gdrn-weights 'weights/gdrn_{ds}.pth' [--device cpu]

Per dataset the GDRN config is the named recipe ``--config`` with ``{ds}``
replaced (default ``{ds}_convnext_base``, ``gdrnpp_bop2022_torch/configs.py``;
the JAX tool reads ``<config-dir>/<ds><config-suffix>`` files instead), with
every ``--opts key=value`` over it (``{ds}`` replaced too) in every GDRN
stage. ``--mode train`` or ``both`` runs ``train_gdrn`` first. In ``eval``
and ``both``, unless the config names a det file that exists, ``test_yolox``
writes the handoff json (``--dataset <ds> --split <split of datasets.test>
--size --input-size``, weights from ``--yolox-ckpt``, or random with
``--yolox-allow-random``); ``test_gdrn`` serves it
(``datasets.det_files_test``) and scores it. GDRN weights come from
``--gdrn-weights`` (a file pattern), ``--gdrn-ckpt`` (a checkpoint
directory pattern: its newest checkpoint), the checkpoint that ``--mode
both`` trained, or ``--gdrn-seed`` (random weights, the JAX tool's random
init). ``--dataset-meta`` JSON files register datasets in every stage.
A dataset whose stage fails is skipped. Writes ``<out>/sweep_summary.json``:
each dataset's ``scores.json`` and their ``mean_AR``; returns 1 when no
dataset produced scores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_DATASETS = ["ycbv", "lmo", "tless", "tudl", "icbin", "itodd", "hb"]
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(module: str, args: list) -> int:
    """python -m gdrnpp_bop2022_torch.tools.<module> args, with this
    checkout's package importable; the return code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", f"gdrnpp_bop2022_torch.tools.{module}", *args]
    print("+ " + " ".join(cmd), flush=True)
    return subprocess.call(cmd, env=env)


def stage_config(args, ds: str):
    """(config name, opts) of a dataset's GDRN stages, and the config."""
    from ..config import parse_opts, replace_cfg
    from .test_gdrn import load_config
    name = args.config.replace("{ds}", ds)
    opts = [f"datasets.root={args.root!r}"] + [o.replace("{ds}", ds) for o in args.opts]
    return name, opts, replace_cfg(load_config(name), parse_opts(opts))


def gen_detections(ds: str, cfg, args, common: list) -> str | None:
    """test_yolox on the config's test split: the handoff json, or None."""
    test_name = cfg.datasets.test[0]
    split = test_name.split("_", 1)[1] if "_" in test_name else "test"
    out_dir = os.path.join(args.out, f"yolox_{ds}")
    cmd = ["--dataset", ds, "--root", args.root, "--split", split,
           "--size", args.yolox_size, "--input-size", str(args.yolox_input_size),
           "--out", out_dir, *common]
    if args.yolox_ckpt:
        cmd += ["--ckpt", args.yolox_ckpt.replace("{ds}", ds)]
    elif args.yolox_allow_random:
        cmd += ["--allow-random-weights"]
    rc = _run("test_yolox", cmd)
    if rc != 0:
        print(f"[{ds}] detector eval failed rc={rc}")
        return None
    det_json = os.path.join(out_dir, f"yolox_{ds}_{split}_bboxes.json")
    return det_json if os.path.exists(det_json) else None


def newest_checkpoint(ckpt_dir: str) -> str | None:
    from ..engine.checkpoint import CheckpointManager
    if not os.path.isdir(ckpt_dir):
        return None
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    return None if step is None else mgr.path(step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    ap.add_argument("--root", default="datasets/BOP_DATASETS")
    ap.add_argument("--mode", choices=["train", "eval", "both"], default="eval")
    ap.add_argument("--config", default="{ds}_convnext_base",
                    help="GDRN config name, '{ds}' replaced (configs.py, or <ds>SO/<obj>)")
    ap.add_argument("--opts", action="extend", nargs="+", default=[],
                    help="key=value overrides for every GDRN stage, '{ds}' replaced; repeatable")
    ap.add_argument("--out", default="output/bop_sweep")
    ap.add_argument("--yolox-size", default="yolox_x")
    ap.add_argument("--yolox-input-size", type=int, default=640)
    ap.add_argument("--yolox-ckpt", default=None,
                    help="train_yolox checkpoint dir pattern, '{ds}' replaced")
    ap.add_argument("--yolox-allow-random", action="store_true",
                    help="forwarded to test_yolox --allow-random-weights (smoke runs only)")
    ap.add_argument("--gdrn-weights", default=None, help="GDRN .pth pattern, '{ds}' replaced")
    ap.add_argument("--gdrn-ckpt", default=None,
                    help="GDRN checkpoint dir pattern, '{ds}' replaced: its newest checkpoint")
    ap.add_argument("--gdrn-seed", type=int, default=None,
                    help="random GDRN weights from this seed")
    ap.add_argument("--dataset-meta", nargs="+", default=[],
                    help="JSON files of datasets to register in every stage")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, every stage")
    args = ap.parse_args(argv)

    from ..datasets.meta import register_meta_files
    register_meta_files(args.dataset_meta)
    common = ["--device", args.device]
    if args.dataset_meta:
        common += ["--dataset-meta", *args.dataset_meta]

    os.makedirs(args.out, exist_ok=True)
    summary = {}
    for ds in args.datasets:
        try:
            name, opts, cfg = stage_config(args, ds)
        except (ValueError, KeyError) as e:
            print(f"[skip] no config for {ds}: {e}")
            continue

        trained = None
        if args.mode in ("train", "both"):
            rc = _run("train_gdrn", ["--config", name, "--opts", *opts, *common])
            if rc != 0:
                print(f"[{ds}] training failed rc={rc}")
                continue
            trained = newest_checkpoint(os.path.join(cfg.output_dir, "ckpt"))

        if args.mode in ("eval", "both"):
            eval_opts = list(opts)
            # the stage-1 -> stage-2 handoff: detect unless the config names
            # a det file that exists
            if not [p for p in cfg.datasets.det_files_test if os.path.exists(p)]:
                det_json = gen_detections(ds, cfg, args, common)
                if det_json is None:
                    continue
                eval_opts.append(f"datasets.det_files_test=({det_json!r},)")
            if args.gdrn_weights:
                weights = ["--weights", args.gdrn_weights.replace("{ds}", ds)]
            elif args.gdrn_ckpt or trained:
                ckpt = (newest_checkpoint(args.gdrn_ckpt.replace("{ds}", ds))
                        if args.gdrn_ckpt else trained)
                if ckpt is None:
                    print(f"[{ds}] no checkpoint under {args.gdrn_ckpt}")
                    continue
                weights = ["--weights", ckpt]
            elif args.gdrn_seed is not None:
                weights = ["--seed", str(args.gdrn_seed)]
            else:
                print(f"[{ds}] no GDRN weights: pass --gdrn-weights, --gdrn-ckpt, "
                      "--gdrn-seed or --mode both")
                continue
            rc = _run("test_gdrn", ["--config", name, "--opts", *eval_opts, *weights, *common])
            if rc != 0:
                print(f"[{ds}] eval failed rc={rc}")
                continue
            scores_path = os.path.join(cfg.output_dir, "inference", cfg.datasets.test[0],
                                       "scores.json")
            if os.path.exists(scores_path):
                with open(scores_path) as f:
                    summary[ds] = json.load(f)

    if summary:
        ars = [v.get("AR") for v in summary.values() if v.get("AR") is not None]
        summary["mean_AR"] = sum(ars) / len(ars) if ars else None
        out_path = os.path.join(args.out, "sweep_summary.json")
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps(summary, indent=2))
        print(f"-> {out_path}")
    return 0 if summary else 1


if __name__ == "__main__":
    sys.exit(main())
