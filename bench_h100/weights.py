"""Random weights from the seed, made on the device in one draw.

Every parameter is a slice of one standard-normal draw, scaled and shifted
by the first rule that matches its name: the configuration's ``init`` rules
(a regular expression, then ``mean`` and ``std``, either of which may be a
list, or ``gain`` for gain / sqrt(fan_in)), then the defaults: matrices and
kernels at 1 / sqrt(fan_in), 1-D weights (norms) at 1 +- 0.1, biases at
0 +- 0.1.
"""

from __future__ import annotations

import math
import re

import torch

DEFAULT_RULES = ({"match": r"\.bias$", "mean": 0.0, "std": 0.1},
                 {"match": r"\.weight$", "dims": 1, "mean": 1.0, "std": 0.1},
                 {"match": r"\.weight$", "gain": 1.0})


def _rule(name: str, shape, rules):
    for r in rules:
        if re.search(r["match"], name) and r.get("dims", len(shape)) == len(shape):
            return r
    raise ValueError(f"no init rule for {name} {tuple(shape)}")


@torch.no_grad()
def make_weights(shapes: dict, seed: int, device, rules=()) -> dict:
    """{name: fp32 tensor of shapes[name]} on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[off:off + n].view(shape)
        off += n
        r = _rule(name, shape, tuple(rules) + DEFAULT_RULES)
        if "gain" in r:
            w.mul_(r["gain"] / math.sqrt(n / shape[0]))
        else:
            w.mul_(torch.as_tensor(r["std"], dtype=torch.float32, device=device))
            w.add_(torch.as_tensor(r["mean"], dtype=torch.float32, device=device))
        out[name] = w
    return out
