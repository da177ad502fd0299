"""b1_roofline_pct: the ConvNeXt LayerNorms' bytes bound over their device time.

Bytes (``counts.layer_norm_bytes``): from the configuration's shapes at the
forward's batch, each input and output element once and the fp32 weight and
bias, so the count reads the same work whatever implements the LayerNorm.
Time: the traced stretch's kernels named ``layer_norm_rows`` (kernel B1's
forward), grouped by exact name; each name's mean time is multiplied by its
share of the records and by the launches of the stretch, as the program's
counter ``layer_norm.launches`` gives them, so a record the profiler dropped
does not count as a faster kernel. Over the forwards of the stretch, against
the card's HBM bandwidth (``peaks.py``)."""

import sys

from bench_h100.counts import layer_norm_bytes
from bench_h100.peaks import peak

KERNEL = "layer_norm_rows"


def _launches():
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    return layer_norm.launches


def install(run):
    run.trace.counters["b1_launches"] = _launches
    return []


def read(run):
    bw = peak(run.device_name, "hbm_bytes_per_s")
    tr, fwd = run.trace, run.forwards.get("trace", 0)
    if bw is None or tr is None or not fwd:
        return None
    kernels = tr.kernels(KERNEL)
    records = sum(n for _, n in kernels.values())
    launches = run.trace.counted.get("b1_launches", 0)
    if not records or not launches:
        return None
    print(f"b1_roofline_pct: {launches} launches over {fwd} forwards, {records} kernel records "
          f"in the trace", file=sys.stderr)
    us = sum(total for total, _ in kernels.values()) * launches / records
    batch = run.rows["trace"] // fwd
    return 100.0 * layer_norm_bytes(run.arch, batch) * fwd / bw / (us * 1e-6)
