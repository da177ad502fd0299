"""backbone_ms: ms a batch in the ConvNeXt backbones (``model.backbone`` and,
in the dual stream, ``model.depth_backbone``), by CUDA events from forward
pre- and post-hooks, summed over the streams, mean over the window's batches."""

from bench_h100.spans import Timed

MODULES = ("backbone", "depth_backbone")


def install(run):
    if not run.cuda:
        return []
    t = run.store["backbone_ms"] = Timed(run)
    return t.modules([getattr(run.model, n) for n in MODULES
                      if getattr(run.model, n, None) is not None])


def read(run):
    t = run.store.get("backbone_ms")
    return t.per_batch_ms() if t else None
