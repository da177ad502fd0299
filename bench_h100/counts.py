"""Work counted from the configuration's shapes, whatever implements it.

``layer_norm_bytes``: the bytes the ConvNeXt LayerNorms of one forward must
move at a batch of ROIs: each input element read once, each output element
written once (in the compute dtype), and the fp32 weight and bias.
``flops_per_roi``: the multiply-adds (counted as 2 FLOPs) of the
reference's network for one ROI, by ``torch.utils.flop_counter`` over the
reference forward on meta tensors; convolutions, matrix products and
einsums count, elementwise work, norms and the pose decode do not, and the
depth refinement (if any) is not part of the forward.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import gdrn

PN = gdrn.PN
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_norm_shapes(arch) -> list:
    """(rows per ROI, channels) of every LayerNorm of one backbone."""
    depths, dims = arch["widths"]["backbone_depths"], arch["widths"]["backbone_dims"]
    side = arch[PN + "input_res"] // 4
    shapes = [(side * side, dims[0])]                           # the stem's
    for s in range(4):
        if s > 0:
            shapes.append((side * side, dims[s - 1]))           # the downsample's
            side //= 2
        shapes += [(side * side, dims[s])] * depths[s]
    return shapes


def backbones(arch) -> int:
    return 2 if "dstream" in arch[PN + "name"] else 1


def layer_norm_bytes(arch, batch: int) -> int:
    e = DTYPE_BYTES[arch["model.compute_dtype"]]
    per = sum(batch * rows * c * 2 * e + 2 * c * 4 for rows, c in layer_norm_shapes(arch))
    return per * backbones(arch)


def flops_per_roi(arch) -> int:
    meta = lambda *s: torch.zeros(s, device="meta")     # noqa: E731
    P = {k: meta(*s) for k, s in gdrn.param_shapes(arch).items()}
    r, o = arch[PN + "input_res"], arch[PN + "output_res"]
    depth = meta(1, r, r, 3 if arch["input.bp_depth"] else 1) if backbones(arch) == 2 else None
    with FlopCounterMode(display=False) as fc:
        gdrn.forward(P, arch, meta(1, r, r, 3), depth, torch.zeros(1, dtype=torch.long,
                                                                   device="meta"),
                     meta(1, o, o, 2), meta(1, 3), meta(1, 3, 3), meta(1, 2), meta(1, 2),
                     meta(1))
    return int(fc.get_total_flops())
