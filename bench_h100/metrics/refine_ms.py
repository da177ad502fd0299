"""refine_ms: ms a batch in the depth refinement (``eval/pnp_eval.py::
depth_refine_batch``, which renders through kernel B2), by CUDA events around
each call: the traced run wraps the name ``depth_refine_batch`` in
``engine.inference``. Mean over the window's batches; nothing where the cell
does not refine."""

from bench_h100.spans import Timed


def install(run):
    if not run.cuda:
        return []
    from gdrnpp_bop2022_torch.engine import inference
    t = run.store["refine_ms"] = Timed(run)
    return [t.function(inference, "depth_refine_batch")]


def read(run):
    t = run.store.get("refine_ms")
    return t.per_batch_ms() if t else None
