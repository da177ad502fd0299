"""YOLOX detector training on one card.

The port's counterpart of ``tools/train_yolox.py`` (reference
det/yolox/tools/main_yolox.py + train_yolox.sh):

    python -m gdrnpp_bop2022_torch.tools.train_yolox --config ycbv \\
        --root datasets/BOP_DATASETS [--total-iters N] [--opts batch_size=8 ...] \\
        [--device cpu]

``--config`` names a BOP'22 recipe of ``configs.yolox`` (yolox-x, GN, Ranger
1e-3 @ 64, EMA, mosaic + mixup, multiscale (14, 26) x 32); without it,
``--dataset`` trains ``YoloxConfig``'s defaults. Flags, then ``--opts
key=value``, override it. The recipe's epochs become iterations from the
indexed image count (epoch = images // batch_size). Writes
``metrics_yolox.json`` and ``ckpt_yolox/`` under ``--out`` (default
``output/yolox/<dataset>``); ``test_yolox --ckpt <out>/ckpt_yolox`` serves
the result. As in the JAX CLI, no eval function is passed, so neither the
in-train eval nor precise BN runs from here. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="a detector recipe of configs.yolox (e.g. ycbv, tless_real_pbr)")
    ap.add_argument("--opts", nargs="*", default=[],
                    help="dotted overrides, e.g. batch_size=8 aug.mosaic_prob=0.5")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--root", default="datasets/BOP_DATASETS")
    ap.add_argument("--splits", nargs="+", default=None)
    ap.add_argument("--size", default=None)
    ap.add_argument("--input-size", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--total-iters", type=int, default=None,
                    help="override the recipe's epoch-derived iteration count")
    ap.add_argument("--no-aug-iters", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--norm", default=None, choices=["GN", "BN"])
    ap.add_argument("--precise-bn-iters", type=int, default=None,
                    help="recompute BN statistics over N clean batches before each "
                         "in-train eval (reference PreciseBN hook)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import configs
    from ..config import YoloxConfig, parse_opts, replace_cfg
    from ..datasets.bop_data import index_bop_split
    from ..datasets.meta import get_meta
    from ..datasets.yolox_loader import det_records_from_instances
    from ..engine.yolox_trainer import train_yolox

    if args.config:
        cfg = configs.yolox(args.config)
    else:
        if args.dataset is None:
            ap.error("either --config or --dataset is required")
        cfg = YoloxConfig(dataset=args.dataset)
    flag_over = {k: v for k, v in {
        "dataset": args.dataset,
        "train_splits": tuple(args.splits) if args.splits else None,
        "size": args.size, "input_size": args.input_size,
        "batch_size": args.batch_size, "output_dir": args.out,
        "norm": args.norm,
        "test.precise_bn_iters": args.precise_bn_iters,
    }.items() if v is not None}
    if flag_over:
        cfg = replace_cfg(cfg, flag_over)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))

    meta = get_meta(cfg.dataset)
    num_classes = meta.num_classes if cfg.num_classes == -1 else cfg.num_classes
    out = cfg.output_dir or f"output/yolox/{meta.name}"
    records = []
    for split in cfg.train_splits:
        records.extend(index_bop_split(os.path.join(args.root, meta.name, split), meta,
                                       cache_path=os.path.join(out, f"index_{split}.pkl")))
    det_records = det_records_from_instances(records)
    print(f"{len(det_records)} training images")

    # the recipe's epochs -> iterations (reference epoch_len)
    epoch_len = max(1, len(det_records) // cfg.batch_size)
    total_iters = (args.total_iters if args.total_iters is not None
                   else cfg.total_epochs * epoch_len)
    no_aug_iters = (args.no_aug_iters if args.no_aug_iters is not None
                    else min(cfg.no_aug_epochs * epoch_len, total_iters))
    return train_yolox(
        det_records, num_classes, out, size=cfg.size,
        input_size=cfg.input_size, batch_size=cfg.batch_size,
        total_iters=total_iters, no_aug_iters=no_aug_iters,
        base_lr=cfg.basic_lr_per_img, weight_decay=cfg.weight_decay,
        optimizer=cfg.optimizer,
        warmup_iters=cfg.warmup_epochs * epoch_len,
        grad_clip=cfg.grad_clip,
        aug=dataclasses.asdict(cfg.aug),
        random_size=cfg.random_size,
        multiscale_period=cfg.multiscale_period,
        ema_decay=cfg.ema_decay, norm=cfg.norm, seed=cfg.seed,
        ckpt_period=max(1, cfg.ckpt_period_epochs * epoch_len),
        eval_period=(cfg.eval_period_epochs * epoch_len if cfg.eval_period_epochs > 0 else 0),
        precise_bn_iters=cfg.test.precise_bn_iters, device=args.device)


if __name__ == "__main__":
    main()
