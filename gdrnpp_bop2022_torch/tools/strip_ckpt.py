"""Strip a training checkpoint to its weights for release.

The port's counterpart of ``tools/strip_ckpt.py`` (reference
tools/remove_optim_from_ckpt.py; the released checkpoints are
``model_final_wo_optim.pth``):

    python -m gdrnpp_bop2022_torch.tools.strip_ckpt --ckpt output/run/ckpt \\
        [--step 120000] [--out model_final_wo_optim.pth] [--use-ema]

``--ckpt`` is a checkpoint file ``ckpt_<step>.pth`` that ``train_gdrn``
wrote (``engine/checkpoint.py``: model, EMA, optimizer, step, generator
states) or its directory (the newest step, or ``--step``). Writes
``{"step", "model"}``: the model's weights, or with ``--use-ema`` the EMA
weights (what the reference releases when EMA is on); the optimizer and
generator states are dropped. ``test_gdrn --weights`` serves the result.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch


def checkpoint_file(ckpt: str, step: Optional[int] = None) -> str:
    """The checkpoint file of a file or directory argument."""
    if os.path.isfile(ckpt):
        return ckpt
    from ..engine.checkpoint import CheckpointManager
    mgr = CheckpointManager(ckpt)
    step = step if step is not None else mgr.latest_step()
    if step is None or not os.path.exists(mgr.path(step)):
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' of step {step}'} "
                                f"in {ckpt}")
    return mgr.path(step)


def strip(ckpt: str, out_path: str, step: Optional[int] = None, use_ema: bool = False) -> int:
    """Write the weights-only checkpoint; returns its step."""
    full = torch.load(checkpoint_file(ckpt, step), map_location="cpu", weights_only=False)
    weights = full["ema"] if use_ema and full.get("ema") is not None else full["model"]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save({"step": int(full["step"]), "model": weights}, out_path)
    return int(full["step"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a ckpt_<step>.pth or its directory")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--out", default=None, help="default: <ckpt>_wo_optim.pth")
    ap.add_argument("--use-ema", action="store_true",
                    help="release the EMA weights (what the reference ships with EMA on)")
    args = ap.parse_args(argv)
    out = args.out or args.ckpt.rstrip("/").removesuffix(".pth") + "_wo_optim.pth"
    step = strip(args.ckpt, out, args.step, args.use_ema)
    print(f"wrote the {'EMA ' if args.use_ema else ''}weights of step {step} to {out}")
    return out


if __name__ == "__main__":
    main()
