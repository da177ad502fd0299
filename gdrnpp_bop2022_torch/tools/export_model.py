"""Export the GDRN forward as a program that serves without the model's code.

The port's counterpart of ``tools/export_model.py`` (the JAX package's
StableHLO export; reference det/yolox/tools/export_onnx.py,
export_torchscript.py):

    python -m gdrnpp_bop2022_torch.tools.export_model --config ycbv_convnext_base \\
        (--weights model_final.pth | --seed 0) --out export/gdrn_ycbv \\
        [--batch-size 64] [--opts ...] [--device cpu]

``torch.export.export`` traces the forward at a fixed batch of
``utils/fake_data.fake_gdrn_batch`` inputs with the weights as an input, as
the JAX tool passes ``params`` to the jitted function:
``program(state, roi_img, roi_labels, roi_coord_2d, roi_cams, roi_centers,
roi_whs, roi_extents, resize_ratios) -> (rot, trans)``, ``state`` being the
model's state dict. ``torch.export.save`` writes it to
``<out>/gdrn_forward.pt2`` and the weights go to ``<out>/weights.pth``:
a training checkpoint's EMA weights when it has them and
``model.ema_enabled`` is set (as ``test_gdrn --weights`` serves them), else
its weights, or weights drawn from ``--seed``. The tool then reloads the
program, runs it on the same inputs and prints its largest difference from
the eager model. The program is traced on ``--device`` and runs there.

B1 is the operator ``gdrnpp::layer_norm``: the saved program calls it, so
import ``gdrnpp_bop2022_torch.ops.layer_norm`` before ``load_program``
(which does) or ``torch.export.load``.
"""

from __future__ import annotations

import argparse
import os

import torch

INPUTS = ("roi_img", "roi_labels", "roi_coord_2d", "roi_cams", "roi_centers", "roi_whs",
          "roi_extents", "resize_ratios")
PROGRAM, WEIGHTS = "gdrn_forward.pt2", "weights.pth"


class Serving(torch.nn.Module):
    """(state, *inputs) -> (rot, trans): the model's forward with its state
    dict as an argument. The model is held outside the module tree, so the
    program carries no copy of its weights."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.__dict__["model"] = model

    def forward(self, state, *inputs):
        out = torch.func.functional_call(self.model, state, inputs)
        return out["rot"], out["trans"]


def example_inputs(cfg, batch_size: int, device, seed: int = 0) -> tuple:
    """A fake_gdrn_batch as the forward's arguments on ``device``."""
    from ..utils.fake_data import fake_gdrn_batch
    pc = cfg.model.pose_net
    b = fake_gdrn_batch(batch_size, pc.input_res, pc.output_res, pc.num_classes,
                        pc.geo_head.num_regions, num_points=8, seed=seed)
    b["roi_labels"] = b["roi_labels"].astype("int64")     # as build_test_batch serves
    return tuple(torch.from_numpy(b[k]).to(device) for k in INPUTS)


def export_program(model: torch.nn.Module, inputs: tuple):
    """The exported program of ``Serving(model)`` at these inputs; the
    model's parameters are frozen first (serving takes no gradient, so B1
    writes no statistics)."""
    model.eval().requires_grad_(False)
    state = dict(model.state_dict())
    program = torch.export.export(Serving(model), (state, *inputs))
    # the program keeps its example inputs, the weights among them; drop
    # them so that the weights are saved once, in weights.pth
    program.example_inputs = None
    return program


def load_program(out_dir: str):
    """(program module, state dict on the CPU) of an export directory: call
    ``program(state, *inputs)`` with state and inputs on the device it was
    exported on."""
    from ..ops import layer_norm  # noqa: F401  (registers gdrnpp::layer_norm)
    # without the guard submodule, which re-checks every input (the ~350
    # state tensors included) on the host at each call; the module's
    # pre-hook still checks the inputs against the traced spec
    program = torch.export.load(os.path.join(out_dir, PROGRAM)).module(check_guards=False)
    # a plain dict, as traced (the program's input spec tells the two apart)
    return program, dict(torch.load(os.path.join(out_dir, WEIGHTS), map_location="cpu"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default",
                    help="'default', a GDRN recipe of configs.py or <dataset>SO/<obj>")
    ap.add_argument("--opts", nargs="*", default=[], help="key=value overrides")
    w = ap.add_mutually_exclusive_group(required=True)
    w.add_argument("--weights", help="a .pth state dict or training checkpoint")
    w.add_argument("--seed", type=int, help="random weights drawn from this seed")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import parse_opts, replace_cfg
    from ..models.gdrn import build_gdrn
    from ..utils.weights import seeded_state_dict
    from .test_gdrn import load_config, weights_to_serve

    cfg = load_config(args.config)
    if args.opts:
        cfg = replace_cfg(cfg, parse_opts(args.opts))
    model = build_gdrn(cfg, device=args.device)
    if args.weights:
        sd = weights_to_serve(torch.load(args.weights, map_location="cpu"),
                              cfg.model.ema_enabled)
    else:
        sd = seeded_state_dict(model, args.seed)
    model.load_state_dict(sd, strict=True)
    inputs = example_inputs(cfg, args.batch_size, args.device)
    program = export_program(model, inputs)
    os.makedirs(args.out, exist_ok=True)
    torch.export.save(program, os.path.join(args.out, PROGRAM))
    torch.save(model.state_dict(), os.path.join(args.out, WEIGHTS))
    size = os.path.getsize(os.path.join(args.out, PROGRAM)) / 1e6
    print(f"exported the GDRN forward at batch {args.batch_size} ({size:.1f} MB program) "
          f"and its weights -> {args.out}")

    # self-check: reload and run, as the JAX tool does
    reloaded, state = load_program(args.out)
    state = {k: v.to(args.device) for k, v in state.items()}
    with torch.inference_mode():
        rot, trans = reloaded(state, *inputs)
        out = model(*inputs)
    err = max(float((rot - out["rot"]).abs().max()), float((trans - out["trans"]).abs().max()))
    print(f"reload check ok: rot {tuple(rot.shape)} trans {tuple(trans.shape)}, "
          f"largest difference from the eager model {err:.3g}")
    return {"out": args.out, "err": err, "program": reloaded, "state": state}


if __name__ == "__main__":
    main()
