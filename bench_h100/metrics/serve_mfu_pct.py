"""serve_mfu_pct: the window's valid ROIs times the FLOPs of one ROI's forward
(``counts.flops_per_roi``: the plain reference's network under
``torch.utils.flop_counter``, the depth refinement left out), over the
window's seconds times the card's dense bf16 peak (``peaks.py``)."""

from bench_h100.counts import flops_per_roi
from bench_h100.peaks import peak


def read(run):
    p = peak(run.device_name, "bf16_flops")
    if p is None:
        return None
    return 100.0 * run.window_rois * flops_per_roi(run.arch) / (run.window_s * p)
