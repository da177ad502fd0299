"""head_ms: ms a batch in the heads: the geo head, the fusion net where the
model has one, and the PnP net, by CUDA events from forward
pre- and post-hooks, summed, mean over the window's batches."""

from bench_h100.spans import Timed

MODULES = ("geo_head_net", "fuse_net", "pnp_net")


def install(run):
    if not run.cuda:
        return []
    t = run.store["head_ms"] = Timed(run)
    return t.modules([getattr(run.model, n) for n in MODULES
                      if getattr(run.model, n, None) is not None])


def read(run):
    t = run.store.get("head_ms")
    return t.per_batch_ms() if t else None
