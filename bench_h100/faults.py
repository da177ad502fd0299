"""Faults planted under the served path, to show that the check catches them.

Each fault patches the program where the fault would arise and returns a
handle whose ``remove()`` puts it back. ``test_bench_check.py`` plants them
under whole runs on the CPU; ``calibrate.py --fault name[:size]`` plants one
under the cell's own runs on the card, where its readings are taken.

- ``half_batch``: the forward computes the first half of its ROI rows; the
  rest get the mean of those poses.
- ``answer_moved:<mm>``: the pose decode moves every translation by <mm>
  along x (default 1).
- ``one_slot_moved:<mm>``: the pose decode moves ROI slot 0 of every batch
  by <mm> along x (default 5).
- ``one_slot_turned:<deg>``: the pose decode turns ROI slot 0 of every batch
  by <deg> about its camera z axis (default 1).
- ``render_deep:<pct>``: the depth refinement's render (kernel B2's place)
  reads <pct> per cent deep (default 1).
- ``row_dropped``: the serving loop loses the last row it produced.
"""

from __future__ import annotations

import math

import torch


class Patch:
    def __init__(self, owner, name: str, value):
        self.owner, self.name, self.old = owner, name, getattr(owner, name)
        setattr(owner, name, value)

    def remove(self):
        setattr(self.owner, self.name, self.old)


def half_batch():
    from gdrnpp_bop2022_torch.models.gdrn import GDRN
    fwd = GDRN.forward

    def half(self, **kw):
        out = fwd(self, **kw)
        n = out["rot"].shape[0] // 2
        for k in ("rot", "trans"):
            out[k] = torch.cat([out[k][:n], out[k][:n].mean(0, keepdim=True)
                                .expand_as(out[k][n:])])
        return out
    return Patch(GDRN, "forward", half)


def _decode(alter):
    from gdrnpp_bop2022_torch.models import gdrn
    decode = gdrn.pose_from_centroid_z_rel

    def altered(*args, **kw):
        return alter(*decode(*args, **kw))
    return Patch(gdrn, "pose_from_centroid_z_rel", altered)


def answer_moved(mm: float = 1.0):
    return _decode(lambda R, t: (R, t + torch.tensor([mm * 1e-3, 0.0, 0.0], device=t.device)))


def _slot0(n, device):
    return torch.nn.functional.one_hot(torch.tensor(0), n).to(device)


def one_slot_moved(mm: float = 5.0):
    return _decode(lambda R, t: (R, t + _slot0(t.shape[0], t.device)[:, None]
                                 * torch.tensor([mm * 1e-3, 0.0, 0.0], device=t.device)))


def one_slot_turned(deg: float = 1.0):
    def turn(R, t):
        a = math.radians(deg)
        Rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                           [0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
        pick = _slot0(R.shape[0], R.device).to(torch.bool)[:, None, None]
        return torch.where(pick, Rz @ R, R), t
    return _decode(turn)


def render_deep(pct: float = 1.0):
    from gdrnpp_bop2022_torch.eval import pnp_eval
    from gdrnpp_bop2022_torch.ops import rasterizer

    def deep(*args, **kw):
        d, xyz = rasterizer.render_depth_xyz(*args, **kw)
        return d * (1.0 + pct / 100.0), xyz
    fn = pnp_eval.depth_refine_batch
    return Patch(fn, "__defaults__", fn.__defaults__[:-1] + (deep,))


def row_dropped():
    from gdrnpp_bop2022_torch.engine import inference
    run = inference.run_gdrn_inference
    return Patch(inference, "run_gdrn_inference", lambda *a, **kw: run(*a, **kw)[:-1])


FAULTS = {f.__name__: f for f in (half_batch, answer_moved, one_slot_moved, one_slot_turned,
                                  render_deep, row_dropped)}


def plant(spec: str):
    """``name`` or ``name:size`` -> the planted fault's handle."""
    name, _, size = spec.partition(":")
    return FAULTS[name](float(size)) if size else FAULTS[name]()
