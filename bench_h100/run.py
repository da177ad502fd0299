#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``gdrnpp_bop2022_torch`` on this machine's card.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``bench_h100/configs/<config>.json``), traffic mix
(``bench_h100/traffic/<traffic>.json``) and metrics (one reader each,
``bench_h100/metrics/<metric>.py``); this file knows none of them by name.

Set-up (``setup_s``, from the start of this process): build the program's
model for the configuration, make its weights on the card from the seed and
load them with ``load_state_dict(strict=True)``, make the seed's pool of
frames and pack it into host batches, and serve one batch once to build the
kernels and warm cuDNN and the allocator. The window: the serving loop
``engine.inference.run_gdrn_inference`` is handed the pool's batches in turn
(closed loop, one batch in flight); it serves the first one twice (its own
warm-up) and the window opens when it asks for the second and closes at the
first request after ``--seconds``. ``--trace 1`` adds the per-layer hooks and,
after the window, two stretches of the mix's ``trace_batches`` batches under
the profiler (``trace.py``: the device's activity alone, then with the host's
ops to name the idle gaps), and reports the per-layer metrics instead of the
end-to-end ones.
Then the model is freed and every row served is compared with the plain
reference (``compare.py``). The last line of standard output is the result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse                                                     # noqa: E402
import json                                                         # noqa: E402
import os                                                           # noqa: E402
import sys                                                          # noqa: E402
from pathlib import Path                                            # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gdrnpp_bop2022_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_h100.harness import load_cell, Session
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    session = Session(cell, "cuda")
    out = session.serve(args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value in out.pop("_window").items():
        print(f"window {name} {value!r}", file=sys.stderr)
    out.pop("_rows")
    for name, value in out.pop("_readings").items():
        print(f"reading {name} {value!r}", file=sys.stderr)
    for name, value, limit in out.pop("_compared"):
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
